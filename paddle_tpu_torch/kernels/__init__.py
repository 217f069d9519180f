"""Hand-written CUDA kernels for the hot ops (counterpart of
paddle_tpu/kernels/, whose kernels are Pallas for the TPU).

Sources live in `csrc/` and are compiled for Hopper at first use
(cuda_build.py); each kernel module holds its wrapper, its plain
PyTorch version and a launch count.  Serving kernels are selected
through registry.py behind the `serving_kernels` flag; the flash
attention kernels run for every CUDA call of the `flash_attention` op
(ops/attention.py) and raise on a call they do not take.
"""
from .registry import (  # noqa: F401
    FALLBACK_METRIC,
    Selection,
    kernels_armed,
    kernels_mode,
    register_kernel,
)
from .flash_attention import flash_attention_supports  # noqa: F401
from .paged_attention import (  # noqa: F401
    build_paged_attention,
    paged_attention_supports,
)
