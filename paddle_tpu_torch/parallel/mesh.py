"""Device meshes over a `torch.distributed` process group.

Counterpart of paddle_tpu/parallel/mesh.py.  There a `jax.sharding.Mesh`
names device axes over ICI; here a `Mesh` names axis sizes over the
process group whose ranks each drive one device (NCCL between CUDA
devices, gloo between CPU processes).  Only data-parallel meshes run
yet: the executors read the batch axis, and a model axis raises at the
executor (ROADMAP A8b/A9).

The JAX module's `shard_map`, `pvary`, `count_collectives` and
`collective_bytes` read or build XLA programs and have no counterpart
here (ROADMAP A8b).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch

__all__ = ["Mesh", "PartitionSpec", "make_mesh", "get_places",
           "init_distributed"]


class PartitionSpec(tuple):
    """Per-dim placement of a tensor over mesh axes: one entry per dim,
    None (replicated), an axis name, or a tuple of axis names — the
    `jax.sharding.PartitionSpec` surface, as a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """Named axis sizes over a process group.

    `group` is the torch.distributed group the axes span (None with a
    mesh of one, where no collective is ever issued).  `rank` is this
    process's index in it."""

    def __init__(self, axes: Dict[str, int], group=None):
        self.shape: Dict[str, int] = {str(k): int(v)
                                      for k, v in axes.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.group = group

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def __repr__(self):
        return f"Mesh({self.shape}, group={self.group is not None})"


def make_mesh(axes: Dict[str, int], group=None) -> Mesh:
    """Build a named mesh, e.g. make_mesh({'dp': 2}).

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
