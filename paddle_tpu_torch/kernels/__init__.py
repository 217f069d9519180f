"""Hand-written CUDA kernels for the hot ops (counterpart of
paddle_tpu/kernels/, whose kernels are Pallas for the TPU).

Sources live in `csrc/` and are compiled for Hopper at first use
(cuda_build.py); each kernel module holds its wrapper, its plain
PyTorch version and a launch count.  The paged-attention kernel is
selected through registry.py behind the `serving_kernels` flag.  The
training kernels have no plain path on a CUDA device: flash attention
runs for every CUDA call of the `flash_attention` op
(ops/attention.py), and the fused bucket update and MoE gate/dispatch
through `Selection.require`; each raises on a call it does not take.
On the CPU the registry and the flag decide, as in the JAX package.
The flash forward and the MoE routing forward are also PyTorch ops
(`paddle_tpu_torch::flash_attention_fwd`, `paddle_tpu_torch::
moe_gate_route`), which a program traced by torch.export records in
place of the ctypes launch.
"""
from .registry import (  # noqa: F401
    FALLBACK_METRIC,
    Selection,
    kernels_armed,
    kernels_mode,
    register_kernel,
)
from .flash_attention import flash_attention_supports  # noqa: F401
from .fused_update import (  # noqa: F401
    build_fused_bucket_update,
    fused_update_supports,
)
from .moe_dispatch import (  # noqa: F401
    build_moe_gate_dispatch,
    moe_dispatch_supports,
)
from .paged_attention import (  # noqa: F401
    build_paged_attention,
    paged_attention_supports,
)
