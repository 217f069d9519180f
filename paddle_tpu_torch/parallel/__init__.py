"""Parallelism package: meshes over torch.distributed process groups
with a process group a mesh axis, `shard_map`, the ParallelExecutor
(the bucketed overlap step, the GSPMD step's sync-BN, replicated and
tensor-parallel sharded forms, ZeRO-1), the c_* collective ops, the
sharded embedding, the sharding propagation, and mesh-free MoE
(counterpart of paddle_tpu/parallel/)."""
from . import collective  # noqa: F401  (registers c_* ops)
from .collective import (  # noqa: F401
    shard_embedding_table,
    sharded_embedding_grad,
    sharded_embedding_lookup,
)
from .executor import (  # noqa: F401
    DistributeTranspiler,
    ParallelExecutor,
    ShardingTranspiler,
    SimpleDistributeTranspiler,
)
from .mesh import (  # noqa: F401
    Mesh,
    NamedSharding,
    PartitionSpec,
    collective_bytes,
    count_collectives,
    data_sharding,
    get_places,
    init_distributed,
    make_mesh,
    pvary,
    replicated,
    shard_map,
)
from .moe import drop_rate, load_balance, moe_dense, moe_gate  # noqa: F401
from .spmd import SpmdPlan, propagate_sharding  # noqa: F401
