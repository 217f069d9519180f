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
explicit conv2d and batch_norm gradients; the dense op corpus; sparse
CTR training — the SelectedRows gradient of `embedding(is_sparse=True)`
(core/lod.py), every optimizer of the JAX package with ModelAverage,
the learning-rate decay schedules, and the wide&deep and DeepFM
builders (models/ctr.py); LoD sequences — the LoDTensor value
(core/lod.py), the sequence ops (ops/sequence.py), the recurrent ops
(ops/rnn.py: lstm, lstmp, gru and the unit steps) with their layers,
and the DataFeeder; control flow, tensor arrays and beam search; the
linear-chain CRF ops with chunk_eval, and `io`'s inference pruning;
CTC (ops/ctc.py), hsigmoid and nce (ops/sampling.py), the SSD detection
ops and layers (ops/detection.py, layers/detection.py) and the reader
ops (ops/reader.py); rematerialised segments (`layers.recompute`) and
the memory layer (`memory_optimize`, memory_optimization_transpiler.py,
the compiled mode's frees); `program_to_fn`, the generation builders
(models/transformer.py) and the one-shot `InferenceServer` (serving/);
the rest of the conv ops (ops/conv.py: conv3d, the transposed
convolutions, pool3d, the max pools with index, spp, unpool, row_conv,
conv_shift); persistence (the io ops, `io`'s save/load, inference
models and checkpoints, `Parameters`), the evaluators, the readers and
the prefetch pipeline (reader/), the profiler's host events, the flight
recorder and the `Trainer` with kill-and-resume; the AOT artifact
(`io.export_aot_model`: a `torch.export` program whose hand-written
kernels are PyTorch ops, `paddle_tpu_torch::flash_attention_fwd` and
`paddle_tpu_torch::moe_gate_route`), the native runtime
(native/: channels, thread pool, buddy allocator, the loader behind
`reader.native_pipeline`), the C inference ABI (`capi_runtime`) and the
CSP channels (`make_channel`, `go`); the user-facing tools: the `paddle
train` CLI's jobs (`python -m paddle_tpu_torch.cli`), the profiler's
device half on torch.profiler, the debugger, image, plot and the
dataset parsers (dataset/); the static analysis package (analysis/: the
Program verifier behind `Program.verify` and the executors' pre-flight,
the cost model on the card's chip table, the concurrency lint and the
schedule checker) with the CLI's verify, analyze and concurrency
commands; sharding and collectives (parallel/): ZeRO-1, tensor
parallelism over a 'tp' mesh axis from `layers.shard` annotations or
`param_shardings`, a process group a mesh axis, `shard_map`, the c_*
collective ops and the sharded embedding.
"""
from . import (  # noqa: F401
    amp,
    analysis,
    backward,
    clip,
    debugger,
    evaluator,
    image,
    initializer,
    io,
    kernels,
    layers,
    learning_rate_decay,
    models,
    nets,
    observability,
    optimizer,
    parallel,
    plot,
    profiler,
    reader,
    regularizer,
    serving,
    trainer,
)
from .backward import append_backward, calc_gradient  # noqa: F401
from .core import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    LoDTensor,
    Program,
    Variable,
    create_lod_tensor,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .core.executor import Executor, global_scope, scope_guard  # noqa: F401
from .concurrency import (  # noqa: F401
    Go,
    channel_close,
    channel_recv,
    channel_send,
    go,
    make_channel,
)
from .data_feeder import DataFeeder  # noqa: F401
from .parameters import Parameters  # noqa: F401
from .memory_optimization_transpiler import memory_optimize  # noqa: F401
from .core.framework import Block, Operator, pipeline_stage  # noqa: F401
from .core.lod import SelectedRows, Tensor  # noqa: F401
from .core.scope import Scope  # noqa: F401
from .parallel.executor import (  # noqa: F401
    DistributeTranspiler,
    ParallelExecutor,
    ShardingTranspiler,
    SimpleDistributeTranspiler,
)
from .parallel.pipeline_program import PipelineExecutor  # noqa: F401
from .optimizer import (  # noqa: F401
    SGD,
    Adadelta,
    AdadeltaOptimizer,
    Adagrad,
    AdagradOptimizer,
    Adam,
    Adamax,
    AdamaxOptimizer,
    AdamOptimizer,
    DecayedAdagrad,
    DecayedAdagradOptimizer,
    Ftrl,
    FtrlOptimizer,
    ModelAverage,
    Momentum,
    MomentumOptimizer,
    RMSProp,
    RMSPropOptimizer,
    SGDOptimizer,
)
from .param_attr import ParamAttr  # noqa: F401

__version__ = "0.1.0"
