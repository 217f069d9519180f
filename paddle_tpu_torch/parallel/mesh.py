"""Device meshes over a `torch.distributed` process group.

Counterpart of paddle_tpu/parallel/mesh.py.  There a `jax.sharding.Mesh`
names device axes over ICI; here a `Mesh` names axis sizes over the
process group whose ranks each drive one device (NCCL between CUDA
devices, gloo between CPU processes, and between processes that share
one card).  The rank layout is row-major over the axes in the order
given, as `jax.make_mesh` lays out devices: in {"dp": 2, "tp": 2} the tp
groups are ranks {0, 1} and {2, 3}, the dp groups {0, 2} and {1, 3}.
Each axis gets its own process group (`Mesh.axis_group`), made when the
mesh is, in the same order on every rank.

`shard_map` runs a function on this rank's blocks of its inputs and
assembles the outputs over the axes; `pvary` is the identity.  Where the
JAX package's `count_collectives` and `collective_bytes` read the
collectives of optimized HLO text, here they read the port's collective
record: one entry a collective issued (`AxisGroup.record`), its kind,
dtype, shape and axis.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh", "PartitionSpec", "NamedSharding", "AxisGroup",
           "Collective", "make_mesh", "get_places", "data_sharding",
           "replicated", "init_distributed", "shard_map", "pvary",
           "count_collectives", "collective_bytes"]

# the JAX package's collective kind names (its HLO instruction names)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
         "all-to-all")

class PartitionSpec(tuple):
    """Per-dim placement of a tensor over mesh axes: one entry per dim,
    None (replicated), an axis name, or a tuple of axis names — the
    `jax.sharding.PartitionSpec` surface, as a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A placement over a mesh: the mesh and a PartitionSpec (the
    `jax.sharding.NamedSharding` surface)."""

    mesh: "Mesh"
    spec: PartitionSpec


def data_sharding(mesh, batch_axis: str = "dp") -> NamedSharding:
    """Dim 0 (the batch) split over `batch_axis`, the rest whole."""
    return NamedSharding(mesh, PartitionSpec(batch_axis))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


class Collective(NamedTuple):
    """One entry of a collective record: the JAX package's kind name,
    the dtype and the RESULT shape (an all-gather's gathered tensor, a
    reduce-scatter's block: the logical payload, as collective_bytes
    counts HLO result shapes), and the mesh axis."""

    kind: str
    dtype: str
    shape: Tuple[int, ...]
    axis: str


class AxisGroup:
    """The collectives of one mesh axis, over its process group.

    `size` is the axis size, `index` this rank's coordinate on it,
    `ranks` the global ranks of this rank's group along the axis, in
    axis order.  An axis of size 1 issues nothing: every collective is
    the identity there (as XLA removes a collective over one device).
    Every collective issued is appended to `record` when it is a list.

    A gloo group takes CUDA tensors as they are for all-reduce,
    all-gather, broadcast, reduce-scatter and all_to_all_single (on the
    H100 machine's torch, every dtype the steps move, on sub-groups of a
    2 x 2 mesh: tools/torch_tree_probe.py gloo-dtypes), but send/recv of
    a CUDA tensor (isend + recv too) aborts the process there, so a
    permute and the stage hops' send/recv on a gloo group run on host
    copies.  An NCCL group never copies."""

    def __init__(self, axis: str, size: int, index, group,
                 ranks: Sequence[int]):
        self.axis = axis
        self.size = int(size)
        self._index = index
        self.group = group
        self.ranks = list(ranks)
        self.record: Optional[List[Collective]] = None

    def __repr__(self):
        return (f"AxisGroup({self.axis!r}, size={self.size}, "
                f"index={self.index})")

    @property
    def index(self) -> int:
        """This rank's coordinate on the axis (read from the mesh at
        first use)."""
        if callable(self._index):
            self._index = int(self._index())
        return self._index

    @property
    def gloo(self) -> bool:
        import torch.distributed as dist

        return (self.group is not None
                and dist.get_backend(self.group) == "gloo")

    def _note(self, kind, t):
        if self.record is not None:
            self.record.append(Collective(kind, str(t.dtype).split(".")[-1],
                                          tuple(t.shape), self.axis))

    def all_reduce_(self, t: torch.Tensor, op: str = "sum",
                    async_op: bool = False):
        """Reduce `t` in place over the axis ("sum" or "max") -> a
        handle to wait on when `async_op`, else None."""
        import torch.distributed as dist

        if self.group is None:
            return None
        self._note("all-reduce", t)
        rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        return dist.all_reduce(t, op=rop, group=self.group,
                               async_op=async_op)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: `t` reduced over the axis."""
        out = t.clone()
        self.all_reduce_(out, op)
        return out

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `t` concatenated along `dim` in axis order."""
        import torch.distributed as dist

        if self.group is None:
            return t
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim)
        self._note("all-gather", out)
        return out

    def block(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of `t` along `dim` (no communication)."""
        if self.size == 1:
            return t
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of size {n} is not divisible by "
                             f"the {self.axis!r} axis size {self.size}")
        m = n // self.size
        return t.narrow(dim, self.index * m, m)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum of every rank's `t`, this rank's block along `dim`."""
        import torch.distributed as dist

        if self.group is None:
            return t
        if t.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter: dim {dim} of size "
                             f"{t.shape[dim]} is not divisible by the "
                             f"{self.axis!r} axis size {self.size}")
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // self.size,) + src.shape[1:],
                          dtype=t.dtype, device=t.device)
        dist.reduce_scatter(out, list(src.chunk(self.size)),
                            group=self.group)
        out = out.movedim(0, dim).contiguous()
        self._note("reduce-scatter", out)
        return out

    def broadcast(self, t: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Axis index `root`'s `t`, on every rank."""
        import torch.distributed as dist

        if self.group is None:
            return t
        out = t.clone().contiguous()
        dist.broadcast(out, src=self.ranks[root], group=self.group)
        # the JAX package writes c_broadcast as a masked psum
        self._note("all-reduce", out)
        return out

    def permute(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """The `t` of axis index (i - shift) mod n on axis index i."""
        import torch.distributed as dist

        if self.group is None:
            return t
        n, i = self.size, self.index
        dst, src = self.ranks[(i + shift) % n], self.ranks[(i - shift) % n]
        host = t.is_cuda and self.gloo
        send = (t.cpu() if host else t).contiguous()
        got = torch.empty_like(send)
        if dst == self.ranks[i]:
            got.copy_(send)
        else:
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, dst, self.group),
                dist.P2POp(dist.irecv, got, src, self.group)])
            for r in reqs:
                r.wait()
        got = got.to(t.device) if host else got
        self._note("collective-permute", got)
        return got

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """`jax.lax.all_to_all(..., tiled=True)`: `t` cut into `size`
        blocks along `split_dim`, block j sent to axis index j, and the
        blocks received concatenated along `concat_dim` in axis order."""
        import torch.distributed as dist

        if self.group is None:
            return t
        if t.shape[split_dim] % self.size:
            raise ValueError(f"all_to_all: dim {split_dim} of size "
                             f"{t.shape[split_dim]} is not divisible by the "
                             f"{self.axis!r} axis size {self.size}")
        src = t.movedim(split_dim, 0).contiguous()
        got = torch.empty_like(src)
        dist.all_to_all_single(got, src, group=self.group)
        out = torch.cat([c.movedim(0, split_dim)
                         for c in got.chunk(self.size)], dim=concat_dim)
        self._note("all-to-all", out)
        return out

    def send(self, t: torch.Tensor, to: int):
        """Send `t` to axis index `to` without waiting -> a handle whose
        `wait()` returns once the buffer may be reused (it holds the
        buffer: a CUDA tensor on a gloo group is sent from a host copy).
        Recorded as a collective-permute, the JAX package's stage hop."""
        import torch.distributed as dist

        buf = (t.cpu() if t.is_cuda and self.gloo else t).contiguous()
        work = dist.isend(buf, self.ranks[to], group=self.group)
        self._note("collective-permute", buf)
        return _Sent(work, buf)

    def recv(self, shape, dtype, frm: int, device) -> torch.Tensor:
        """A tensor of `shape` and `dtype` received from axis index
        `frm`, on `device`."""
        import torch.distributed as dist

        dev = torch.device(device)
        host = dev.type == "cuda" and self.gloo
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if host else dev)
        dist.recv(buf, self.ranks[frm], group=self.group)
        return buf.to(dev) if host else buf


class _Sent:
    """A pending send and the buffer it reads."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self):
        self.work.wait()
        self.buf = None


# (id(process group), mesh axes) -> (the group, {axis: (its sub-group,
# ranks)}), for meshes whose axes need sub-groups of their own
_AXIS_GROUPS: Dict[tuple, tuple] = {}


class Mesh:
    """Named axis sizes over a process group.

    `group` is the torch.distributed group the axes span (None with a
    mesh of one, where no collective is ever issued).  `rank` is this
    process's index in it.  A mesh over a real process group makes one
    process group a mesh axis (a group a line of ranks along it, every
    rank making every group, in axis order): `axis_group(name)`.  An axis
    as large as the whole mesh uses the mesh's group itself; an axis of
    size 1 has none."""

    def __init__(self, axes: Dict[str, int], group=None):
        self.shape: Dict[str, int] = {str(k): int(v)
                                      for k, v in axes.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.group = group
        self.size = math.prod(self.shape.values())
        # axis -> (its process group holding this rank, global ranks)
        self._groups: Dict[str, Tuple[object, List[int]]] = {}
        self._rank = None
        if group is not None and self._real_group():
            self._make_groups()

    def _real_group(self) -> bool:
        import torch.distributed as dist

        return dist.is_available() and isinstance(self.group,
                                                  dist.ProcessGroup)

    def _make_groups(self):
        import torch.distributed as dist

        members = dist.get_process_group_ranks(self.group)
        me = members.index(dist.get_rank())
        self._rank = me
        sizes = [self.shape[a] for a in self.axis_names]
        # a mesh of the same axes over the same group reuses the groups
        # an earlier one made (every rank builds its meshes in one order,
        # so the cache hits alike everywhere; it holds the group, so the
        # key's id stays that group's)
        key = (id(self.group), tuple(self.shape.items()))
        if any(1 < n < self.size for n in sizes):
            if key in _AXIS_GROUPS:
                self._groups = _AXIS_GROUPS[key][1]
                return
            _AXIS_GROUPS[key] = (self.group, self._groups)
        for k, axis in enumerate(self.axis_names):
            if sizes[k] == self.size:
                self._groups[axis] = (self.group, list(members))
                continue
            if sizes[k] == 1:
                self._groups[axis] = (None, [members[me]])
                continue
            # one group a choice of the other axes' coordinates, in
            # row-major order: the same sequence of new_group calls on
            # every rank
            others = [range(s) if j != k else (None,)
                      for j, s in enumerate(sizes)]
            for coord in itertools.product(*others):
                idx = [list(coord) for _ in range(sizes[k])]
                ranks = []
                for i in range(sizes[k]):
                    idx[i][k] = i
                    flat = 0
                    for j, s in enumerate(sizes):
                        flat = flat * s + idx[i][j]
                    ranks.append(members[flat])
                g = dist.new_group(ranks)
                if members[me] in ranks:
                    self._groups[axis] = (g, ranks)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        if self._rank is None:
            import torch.distributed as dist

            self._rank = dist.get_rank(self.group)
        return self._rank

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis `name` (row-major)."""
        rest = self.rank
        for axis in reversed(self.axis_names):
            if axis == name:
                return rest % self.shape[axis]
            rest //= self.shape[axis]
        raise KeyError(f"mesh {self.shape} has no axis {name!r}")

    def axis_group(self, name: str) -> AxisGroup:
        """The collectives over axis `name` for this rank (a new
        AxisGroup, with its own `record`, over the axis's process
        group)."""
        size = self.shape[name]
        if name in self._groups:
            group, ranks = self._groups[name]
        elif size == self.size and self.group is not None:
            # a one-axis mesh (or a fake group a test builds a form with)
            group, ranks = self.group, list(range(size))
        elif size == 1:
            # no collective over it (a mesh of one: rank 0)
            group, ranks = None, [0] if self.group is None else []
        else:
            raise RuntimeError(
                f"mesh {self.shape}: axis {name!r} has no process group — "
                "a multi-axis mesh needs an initialised torch.distributed "
                "group")
        return AxisGroup(name, size, (lambda: self.axis_index(name))
                         if size > 1 else 0, group, ranks)

    def axis_groups(self) -> Dict[str, AxisGroup]:
        """{axis: AxisGroup} for every axis (an ExecContext's `groups`,
        which the c_* ops name by `ring_id`)."""
        return {a: self.axis_group(a) for a in self.axis_names}

    def __repr__(self):
        return f"Mesh({self.shape}, group={self.group is not None})"


def make_mesh(axes: Dict[str, int], group=None) -> Mesh:
    """Build a named mesh, e.g. make_mesh({'dp': 2, 'tp': 2}).

    With an initialised default process group (or an explicit `group`)
    the mesh spans it, and its world size must equal the product of the
    axis sizes.  With no group, a mesh of one is local and issues no
    collective; a larger one raises — call `init_distributed` (or
    `torch.distributed.init_process_group`) first."""
    n = math.prod(int(v) for v in axes.values())
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        if n != 1:
            raise ValueError(
                f"mesh {dict(axes)} needs {n} processes but no "
                "torch.distributed process group is initialised — call "
                "init_distributed() first")
        return Mesh(axes)
    world = dist.get_world_size(group)
    if world != n:
        raise ValueError(f"mesh {dict(axes)} needs {n} processes, the "
                         f"process group has {world}")
    return Mesh(axes, group)


def _blocks(mesh: Mesh, x, spec):
    """This rank's block of `x` under `spec` (None / axis / tuple of axes
    a dim; a tuple splits the dim over the axes' product, the first axis
    slowest)."""
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    for d, e in enumerate(spec):
        if e is None:
            continue
        for axis in (e if isinstance(e, tuple) else (e,)):
            x = mesh.axis_group(axis).block(x, d)
    return x


def _assemble(mesh: Mesh, x, spec):
    """The whole of `x` from every rank's block under `spec`: each split
    dim all-gathered over its axes (the last axis of a tuple first)."""
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    for d, e in enumerate(spec):
        if e is None:
            continue
        for axis in reversed(e if isinstance(e, tuple) else (e,)):
            x = mesh.axis_group(axis).all_gather(x, d)
    return x


def _map_specs(fn, values, specs):
    """fn(value, spec) over a pytree of dicts / lists / tuples, `specs`
    either the same structure or one spec for every leaf."""
    if isinstance(values, dict):
        return {k: _map_specs(fn, v, specs[k] if isinstance(specs, dict)
                              else specs) for k, v in values.items()}
    if isinstance(values, (list, tuple)) and not isinstance(values,
                                                           PartitionSpec):
        subs = (specs if isinstance(specs, (list, tuple))
                and not isinstance(specs, PartitionSpec)
                else [specs] * len(values))
        return type(values)(_map_specs(fn, v, s)
                            for v, s in zip(values, subs))
    return fn(values, specs)


def shard_map(f, *, mesh: Mesh, in_specs, out_specs, axis_names=None):
    """Map `f` over the mesh (the jax.shard_map contract, one process a
    mesh position): `f` runs on this rank's blocks of its arguments,
    sliced by `in_specs` (one spec an argument, or a pytree of them),
    and its outputs are assembled by `out_specs`: a split dim is
    all-gathered over its axes, and `P()` (or None) stays as this rank
    computed it.  Inside `f`, collectives name an axis through the
    mesh's groups (`mesh.axis_groups()`, an ExecContext's `groups`).
    `axis_names` is accepted for the JAX surface; every axis is manual
    here."""
    def mapped(*args):
        specs = in_specs if isinstance(in_specs, (list, tuple)) and \
            not isinstance(in_specs, PartitionSpec) else (in_specs,)
        if len(specs) != len(args):
            raise ValueError(f"shard_map: {len(args)} arguments, "
                             f"{len(specs)} in_specs")
        local = [_map_specs(lambda v, s: _blocks(mesh, v, s), a, s)
                 for a, s in zip(args, specs)]
        out = f(*local)
        return _map_specs(lambda v, s: _assemble(mesh, v, s), out,
                          out_specs)

    return mapped


def pvary(x, axis_names):
    """The identity.  In JAX it marks a replicated value as varying over
    `axis_names` for shard_map's replication checker, a type-system
    marker with no runtime effect; the port has no such checker, so the
    value is returned as it is."""
    return x


def get_places(device_count: Optional[int] = None):
    """Places of this host's devices (reference get_places_op): every
    visible CUDA device.  With none it raises as `CUDAPlace.torch_device`
    does: nothing carries on on the CPU unless the caller passes
    `CPUPlace()` itself."""
    from ..core.executor import CUDAPlace

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        CUDAPlace(0).torch_device()   # raises: no CUDA device
    places = [CUDAPlace(i) for i in range(n)]
    return places[:device_count] if device_count else places


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: int = 1, process_id: int = 0,
                     place=None):
    """Multi-process bring-up: joins this process into a
    `torch.distributed` group of `num_processes` at
    `coordinator_address` ("host:port", rank 0 listens there).  NCCL for
    a CUDA place (the default), gloo for `CPUPlace()`.  No-op for a
    single process.

    Arguments default from the PADDLE_TPU_{COORDINATOR,NUM_PROCESSES,
    PROCESS_ID} environment variables, as in the JAX package."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("PADDLE_TPU_COORDINATOR")
        if coordinator_address is not None:
            num_processes = int(
                os.environ.get("PADDLE_TPU_NUM_PROCESSES", "1"))
            process_id = int(os.environ.get("PADDLE_TPU_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    import torch.distributed as dist

    from ..core.executor import CPUPlace

    backend = "gloo" if isinstance(place, CPUPlace) else "nccl"
    if backend == "nccl":
        from ..core.executor import CUDAPlace, resolve_place

        # one device per process: by default the process's own index
        if place is None:
            place = CUDAPlace(int(process_id)
                              % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(resolve_place(place))
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def count_collectives(record: Sequence[Collective]) -> Dict[str, int]:
    """{kind: count} of a collective record (the JAX package's
    count_collectives over HLO text; kinds with none are left out)."""
    out: Dict[str, int] = {}
    for c in record:
        out[c.kind] = out.get(c.kind, 0) + 1
    return {k: out[k] for k in KINDS if k in out}


def collective_bytes(record: Sequence[Collective]) -> Dict[str, int]:
    """{kind: payload bytes} of a collective record: each entry's result
    shape times its element size, summed by kind (the JAX package's
    convention for HLO result shapes)."""
    out: Dict[str, int] = {}
    for c in record:
        size = math.prod(c.shape) * getattr(torch, c.dtype).itemsize
        out[c.kind] = out.get(c.kind, 0) + size
    return {k: out[k] for k in KINDS if k in out}
