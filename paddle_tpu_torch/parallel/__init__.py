"""Parallelism package: meshes over torch.distributed process groups
with a process group a mesh axis, `shard_map`, the ParallelExecutor
(the bucketed overlap step, the GSPMD step's sync-BN, replicated and
tensor-parallel sharded forms, ZeRO-1, expert parallelism), the
PipelineExecutor (GPipe and 1F1B over 'pp', composed with dp, tp and
sp), ring and Ulysses attention, the c_* collective ops, the sharded
embedding, the sharding propagation, MoE, the composite oracle steps
and sharded checkpoints (counterpart of paddle_tpu/parallel/)."""
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
from .moe import (  # noqa: F401
    drop_rate,
    load_balance,
    moe_dense,
    moe_ffn,
    moe_ffn_a2a,
    moe_gate,
)
from .pipeline import (  # noqa: F401
    bubble_fraction,
    microbatch,
    schedule_steps,
    spmd_pipeline,
    spmd_pipeline_1f1b,
    stack_stage_params,
    unmicrobatch,
)
from .pipeline_program import PipelineExecutor  # noqa: F401
from .ring_attention import (  # noqa: F401
    all_to_all_attention,
    attention_reference,
    ring_attention,
)
from .spmd import SpmdPlan, propagate_sharding  # noqa: F401
