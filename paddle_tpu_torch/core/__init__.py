"""Core of the PyTorch port: IR, registry, places, flags
(counterpart of paddle_tpu/core/)."""
from . import registry  # noqa: F401
from .executor import CPUPlace, CUDAPlace, resolve_place  # noqa: F401
from .framework import (  # noqa: F401
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .lod import (  # noqa: F401
    LoDTensor,
    SelectedRows,
    Tensor,
    TensorArray,
    create_lod_tensor,
)
from .resilience import (  # noqa: F401
    FaultInjector,
    RetryError,
    RetryPolicy,
    fault_injector,
)
