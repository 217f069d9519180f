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

The replica wire server and the warm-start artifact are not ported
yet.
"""
from .batching import (InferenceServer, RequestDeadlineExceeded,
                       ServerSaturated)
from .generation import (GenerationServer, GenerationStream,
                         load_generation_model, save_generation_model,
                         server_from_model_dir)
from .kv_cache import KVPoolExhausted, PagedKVCache

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
]
