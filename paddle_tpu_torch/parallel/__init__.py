"""Parallelism package: meshes over torch.distributed process groups, the
data-parallel ParallelExecutor with its bucketed overlap step, the
sharding propagation, and mesh-free MoE (counterpart of
paddle_tpu/parallel/)."""
from .executor import (  # noqa: F401
    DistributeTranspiler,
    ParallelExecutor,
    ShardingTranspiler,
    SimpleDistributeTranspiler,
)
from .mesh import (  # noqa: F401
    Mesh,
    PartitionSpec,
    get_places,
    init_distributed,
    make_mesh,
)
from .moe import drop_rate, load_balance, moe_dense, moe_gate  # noqa: F401
from .spmd import SpmdPlan, propagate_sharding  # noqa: F401
