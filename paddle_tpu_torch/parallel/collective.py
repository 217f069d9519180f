"""Collective ops, the tensor-parallel autograd collectives and the
sharded embedding.

Counterpart of paddle_tpu/parallel/collective.py.  The seven `c_*` ops
are registered as ordinary ops so that a Program can express them;
`ring_id` names a mesh axis, and each op runs over that axis's group,
taken from the ExecContext (`ctx.groups`, set by ParallelExecutor and
by whoever runs ops inside `shard_map`).  Outside a mesh the axis is
unbound and the op raises, as the JAX package's `jax.lax.p*` lowerings
do outside shard_map; build-time shape inference therefore reports them
as the JAX package's does.  On meta tensors with the axis bound, an op
gives its output's shape without communicating.

`copy_to`, `reduce_from`, `gather_from` and `scatter_to` are Megatron's
four tensor-parallel regions as `torch.autograd.Function`s, each with
its conjugate backward: identity forward with an all-reduce backward,
all-reduce forward with an identity backward, all-gather forward with a
split backward, split forward with an all-gather backward.  `ppermute`
(a ring shift whose backward is the inverse shift) and `all_to_all`
(whose backward swaps the two dims) carry ring and Ulysses attention.  The tensor-
parallel step (parallel/tensor_parallel.py) builds its lowerings from
them, so the generic gradient, which re-runs a forward lowering under
autograd, gets each collective's gradient right.

`sharded_embedding_lookup` is the large-model embedding: the table is
row-sharded over a mesh axis; each rank gathers the ids it owns (zeros
for the rest) and an all-reduce over the axis assembles the vectors.
"""
from __future__ import annotations

import torch

from ..core.execution import data_of, one
from ..core.registry import register_op
from .mesh import AxisGroup, Mesh

__all__ = ["copy_to", "reduce_from", "gather_from", "scatter_to",
           "ppermute", "all_to_all",
           "shard_embedding_table", "sharded_embedding_lookup",
           "sharded_embedding_grad"]


def _group(ctx, attrs, op_type) -> AxisGroup:
    axis = attrs.get("ring_id")
    group = ctx.groups.get(axis)
    if group is None:
        raise NameError(
            f"{op_type}: unbound axis name {axis!r} — a collective op runs "
            "over a mesh axis of the ExecContext (ParallelExecutor's step, "
            f"or ExecContext(groups=mesh.axis_groups())); the context has "
            f"{sorted(ctx.groups)}")
    return group


def _meta(x):
    return isinstance(x, torch.Tensor) and x.device.type == "meta"


def _shape_only(x, dim=None, factor=1.0):
    """A meta tensor of the op's result shape: `x`'s, with dim `dim`
    scaled by `factor` (shape inference of an op whose axis is bound)."""
    shape = list(x.shape)
    if dim is not None:
        shape[dim] = int(shape[dim] * factor)
    return torch.empty(shape, dtype=x.dtype, device=x.device)


@register_op("c_allreduce_sum", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": "dp"})
def c_allreduce_sum(ctx, ins, attrs):
    x = data_of(one(ins, "X"))
    g = _group(ctx, attrs, "c_allreduce_sum")
    return {"Out": x.clone() if _meta(x) else g.all_reduce(x, "sum")}


@register_op("c_allreduce_mean", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": "dp"})
def c_allreduce_mean(ctx, ins, attrs):
    x = data_of(one(ins, "X"))
    g = _group(ctx, attrs, "c_allreduce_mean")
    if _meta(x):
        return {"Out": x.clone()}
    return {"Out": g.all_reduce(x, "sum") / g.size}


@register_op("c_allreduce_max", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": "dp"})
def c_allreduce_max(ctx, ins, attrs):
    x = data_of(one(ins, "X"))
    g = _group(ctx, attrs, "c_allreduce_max")
    return {"Out": x.clone() if _meta(x) else g.all_reduce(x, "max")}


@register_op("c_allgather", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": "dp", "axis": 0})
def c_allgather(ctx, ins, attrs):
    """Every rank's X concatenated along `axis` (tiled)."""
    x = data_of(one(ins, "X"))
    g = _group(ctx, attrs, "c_allgather")
    axis = int(attrs.get("axis", 0)) % max(x.dim(), 1)
    if _meta(x):
        return {"Out": _shape_only(x, axis, g.size)}
    return {"Out": g.all_gather(x, axis)}


@register_op("c_reducescatter", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": "dp", "axis": 0})
def c_reducescatter(ctx, ins, attrs):
    """The sum over the ranks, this rank's block along `axis` (tiled)."""
    x = data_of(one(ins, "X"))
    g = _group(ctx, attrs, "c_reducescatter")
    axis = int(attrs.get("axis", 0)) % max(x.dim(), 1)
    if _meta(x):
        return {"Out": _shape_only(x, axis, 1.0 / g.size)}
    return {"Out": g.reduce_scatter(x, axis)}


@register_op("c_broadcast", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": "dp", "root": 0})
def c_broadcast(ctx, ins, attrs):
    """Axis index `root`'s X on every rank."""
    x = data_of(one(ins, "X"))
    g = _group(ctx, attrs, "c_broadcast")
    if _meta(x):
        return {"Out": x.clone()}
    return {"Out": g.broadcast(x, int(attrs.get("root", 0)))}


@register_op("c_ppermute", inputs=("X",), outputs=("Out",),
             attrs={"ring_id": "dp", "shift": 1})
def c_ppermute(ctx, ins, attrs):
    """Axis index i's X moved to axis index (i + shift) mod n."""
    x = data_of(one(ins, "X"))
    g = _group(ctx, attrs, "c_ppermute")
    if _meta(x):
        return {"Out": x.clone()}
    return {"Out": g.permute(x, int(attrs.get("shift", 1)))}


# ---------------------------------------------------------------------------
# the tensor-parallel regions, with their conjugate backwards
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the axis (a
    replicated input whose consumers run on this rank's block)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward (the partial sums of a row-parallel product);
    the gradient passed through as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along `dim` forward; this rank's block of the gradient
    backward (its consumer runs on the whole value on every rank)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.block(g, ctx.dim).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    """This rank's block along `dim` forward; the gradient all-gathered
    backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.block(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g.contiguous(), ctx.dim), None, None


def copy_to(x, group: AxisGroup):
    return _CopyTo.apply(x, group)


def reduce_from(x, group: AxisGroup):
    return _ReduceFrom.apply(x, group)


def gather_from(x, group: AxisGroup, dim: int):
    return _GatherFrom.apply(x, group, dim)


def scatter_to(x, group: AxisGroup, dim: int):
    return _ScatterTo.apply(x, group, dim)


class _Ppermute(torch.autograd.Function):
    """The ring shift `AxisGroup.permute(x, shift)`; its backward is the
    inverse shift of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return group.permute(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.permute(g.contiguous(), -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    """`AxisGroup.all_to_all`; its backward is the all_to_all with the
    two dims swapped."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return group.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (ctx.group.all_to_all(g.contiguous(), concat_dim, split_dim),
                None, None, None)


def ppermute(x, group: AxisGroup, shift: int = 1):
    """Differentiable ring shift over `group`: axis index i receives the
    `x` of index (i - shift) mod n (`jax.lax.ppermute` with the pairs
    (j, j + shift))."""
    return _Ppermute.apply(x, group, shift)


def all_to_all(x, group: AxisGroup, split_dim: int, concat_dim: int):
    """Differentiable `jax.lax.all_to_all(x, axis, split_dim, concat_dim,
    tiled=True)` over `group`."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


# ---------------------------------------------------------------------------
# sharded embedding
# ---------------------------------------------------------------------------


def shard_embedding_table(mesh: Mesh, table, axis: str = "mp"):
    """This rank's row block of `table` ([vocab, dim], a tensor or an
    array) over `axis`."""
    table = torch.as_tensor(table)
    g = mesh.axis_group(axis)
    rows = table.shape[0] // g.size
    return table[g.index * rows:(g.index + 1) * rows].clone()


def _owned(ids, g: AxisGroup, rows: int):
    local = ids.long() - g.index * rows
    owned = (local >= 0) & (local < rows)
    return owned, torch.clamp(local, 0, rows - 1)


def sharded_embedding_lookup(ids, table, mesh: Mesh, axis: str = "mp"):
    """ids: [n] global ids (the same on every rank); table: this rank's
    row block of a [vocab, dim] table row-sharded over `axis` (vocab //
    axis size rows a rank, as the JAX package splits it).  Each rank
    gathers the ids it owns, zeros for the others, and an all-reduce over
    `axis` assembles the full vectors."""
    g = mesh.axis_group(axis)
    ids = torch.as_tensor(ids, device=table.device)
    owned, safe = _owned(ids, g, table.shape[0])
    vecs = table.index_select(0, safe)
    vecs = torch.where(owned[:, None], vecs, torch.zeros_like(vecs))
    return g.all_reduce(vecs)


def sharded_embedding_grad(ids, grad_out, vocab: int, mesh: Mesh,
                           axis: str = "mp"):
    """The rows of `grad_out` ([n, dim], the same on every rank) added
    into this rank's row block of a dense [vocab, dim] gradient: the
    rows whose ids it owns, duplicates accumulating in id order (the
    CPU's index_add_, a card's sorted segment sum: no atomics)."""
    from ..ops.embedding import sorted_segment_sum

    g = mesh.axis_group(axis)
    rows = vocab // g.size
    ids = torch.as_tensor(ids, device=grad_out.device)
    owned, safe = _owned(ids, g, rows)
    grad = torch.where(owned[:, None], grad_out, torch.zeros_like(grad_out))
    if grad.device.type == "cuda":
        return sorted_segment_sum(safe, grad, rows)
    return torch.zeros((rows, grad.shape[1]), dtype=grad.dtype,
                       device=grad.device).index_add_(0, safe, grad)
