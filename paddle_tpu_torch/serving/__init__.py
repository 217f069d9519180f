"""Generation serving (counterpart of paddle_tpu/serving/).

* **kv_cache** — the paged KV-cache manager: fixed-size blocks carved
  out of ONE preallocated device pool, per-sequence block tables,
  prefix hashing with refcounted sharing and an LRU.
* **generation** — `GenerationServer`: continuous (in-flight) batching
  for autoregressive decode over the paged decoder, with admission and
  deadlines, prefix caching, speculative decoding, hot swap and drain.
* **batching** — `InferenceServer`: the one-shot resident server, its
  buckets captured into CUDA graphs at construction, with dynamic
  batching, deadlines and backpressure.
* **replica** — a TCP front for one `GenerationServer` process
  (JSON-line protocol: generate/ping/stats/flight/swap/drain/resume/
  stop, the JAX package's wire byte for byte) so replicas can be
  health-checked, drained and hot-swapped remotely.

A model dir saved with `warm_start=True` ships the kernels' build cache
beside the parameters (`build_warm_start_artifact`), so a replica
started from it loads its CUDA kernels instead of building them.  The
multi-replica front door (router, autoscaler) lives in
`paddle_tpu_torch.cloud`.
"""
from .batching import (InferenceServer, RequestDeadlineExceeded,
                       ServerSaturated)
from .generation import (GenerationServer, GenerationStream,
                         build_warm_start_artifact,
                         load_generation_model, save_generation_model,
                         server_from_model_dir)
from .kv_cache import KVPoolExhausted, PagedKVCache
from .replica import (ReplicaError, ReplicaServer, ReplicaShed,
                      replica_call, replica_stream)

__all__ = [
    "InferenceServer",
    "ServerSaturated",
    "RequestDeadlineExceeded",
    "PagedKVCache",
    "KVPoolExhausted",
    "GenerationServer",
    "GenerationStream",
    "save_generation_model",
    "load_generation_model",
    "server_from_model_dir",
    "build_warm_start_artifact",
    "ReplicaServer",
    "ReplicaError",
    "ReplicaShed",
    "replica_call",
    "replica_stream",
]
