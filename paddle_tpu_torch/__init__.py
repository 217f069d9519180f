"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

It mirrors paddle_tpu's module layout, so each counterpart sits at the
same relative path, and holds itself to the JAX package in the tests.
It imports torch, numpy and the standard library only — never jax and
never paddle_tpu.  Entry points run on CUDAPlace(0) unless the caller
passes CPUPlace(); with no CUDA device they raise.

Ported so far: the Program IR and the layers the transformer LM builds
with; LM serving — the paged decoder (models/transformer.py) with its
hand-written CUDA paged-attention kernel (kernels/) under the
continuous-batching GenerationServer (serving/); and training — the
interpreter Executor, append_backward, gradient clipping and
regularization, and the SGD/Momentum/Adam optimizers, with the
flash-attention op on hand-written CUDA forward and backward kernels;
data-parallel training through ParallelExecutor's bucketed overlap step
(parallel/), with the fused bucket SGD update in a CUDA kernel; and the
MoE FFN op, with gate and dispatch in a CUDA kernel; bf16 mixed
precision (`fluid.amp`), with explicit gradients for `mul` and
`flash_attention`; conv-net training — conv2d, pool2d, batch_norm,
dropout and accuracy, the ResNet and VGG builders (models/), with
explicit conv2d and batch_norm gradients.
"""
from . import (  # noqa: F401
    amp,
    backward,
    clip,
    initializer,
    kernels,
    layers,
    models,
    nets,
    observability,
    optimizer,
    parallel,
    regularizer,
    serving,
)
from .backward import append_backward, calc_gradient  # noqa: F401
from .core import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .core.executor import Executor, global_scope, scope_guard  # noqa: F401
from .core.framework import Block, Operator, pipeline_stage  # noqa: F401
from .core.scope import Scope  # noqa: F401
from .parallel.executor import (  # noqa: F401
    DistributeTranspiler,
    ParallelExecutor,
    ShardingTranspiler,
    SimpleDistributeTranspiler,
)
from .optimizer import (  # noqa: F401
    SGD,
    Adam,
    AdamOptimizer,
    Momentum,
    MomentumOptimizer,
    SGDOptimizer,
)
from .param_attr import ParamAttr  # noqa: F401

__version__ = "0.1.0"
