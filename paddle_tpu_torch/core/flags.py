"""Runtime flag registry — the gflags analogue.

Counterpart of paddle_tpu/core/flags.py: a process-global registry,
settable from code (`set_flags`) or `PADDLE_TPU_<NAME>` environment
variables at import.  The env prefix is the JAX package's on purpose:
one environment configures either package.  Only the flags this
package reads are defined here.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_DEFS: Dict[str, Any] = {}
_VALUES: Dict[str, Any] = {}
_ON_CHANGE: Dict[str, list] = {}


def on_flag_change(name: str, callback):
    """Register `callback()` to run whenever `set_flags` touches `name` —
    for flags that must take effect immediately rather than at the next
    consumer read (e.g. the metrics switch)."""
    _ON_CHANGE.setdefault(name, []).append(callback)


def define_flag(name: str, default, help_str: str = ""):
    _DEFS[name] = (default, help_str)
    env = os.environ.get("PADDLE_TPU_" + name.upper())
    if env is not None:
        if isinstance(default, bool):
            _VALUES[name] = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            _VALUES[name] = int(env)
        elif isinstance(default, float):
            _VALUES[name] = float(env)
        else:
            _VALUES[name] = env
    else:
        _VALUES[name] = default


def get_flag(name: str):
    return _VALUES[name]


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if k not in _DEFS:
            raise KeyError(f"unknown flag {k!r}; defined: {sorted(_DEFS)}")
        _VALUES[k] = v
    for k in flags:
        for cb in _ON_CHANGE.get(k, ()):
            cb()


def flag_defaults():
    return {k: d for k, (d, _) in _DEFS.items()}


def reset_flags():
    """Every flag back to its default (tests)."""
    set_flags(flag_defaults())


define_flag("metrics", False,
            "arm the observability metrics instruments "
            "(paddle_tpu_torch.observability.metrics).  Off (default): "
            "every instrument is a boolean-test no-op; telemetry-API "
            "metrics (GenerationServer.stats) count regardless")
define_flag("trace_dir", "",
            "directory for Chrome-trace JSON dumps "
            "(paddle_tpu_torch.observability.tracing): setting it "
            "enables span recording and auto-writes trace_<pid>.json "
            "at process exit")
define_flag("amp_bf16", False,
            "mixed precision (paddle_tpu_torch.amp): mul casts float32 "
            "operands to bfloat16 at its input edge, an elementwise op "
            "meeting bfloat16 and float32 computes in bfloat16, softmax "
            "and the cross-entropy losses upcast bfloat16 inputs to "
            "float32, and parameters stay float32 (master weights).  "
            "Read by the op lowerings at BUILD time (shape inference "
            "types the Program's vars) and at RUN time, so keep it "
            "fixed between building a Program and running it")
define_flag("conv_layout", "",
            "conv layout override, read at RUN time by the conv2d "
            "lowering and its gradient: 'NHWC' runs every NCHW-declared "
            "conv2d channels-last (torch.channels_last memory format; "
            "the output stays channels-last, so a conv trunk runs "
            "without transposes between its convs).  '' (default) keeps "
            "each op's declared data_format.  No value changes.  The "
            "Executor's cache keys include it, as amp_bf16")
define_flag("jit_granularity", "block",
            "how much of a program one Executor cache entry covers: "
            "'block' (default) resolves the whole block 0 into one "
            "compiled plan (on a CUDA place captured into one CUDA "
            "graph); 'segment' makes maximal device segments (the mode "
            "host ops already force) even for pure-device programs; "
            "'op' runs the eager interpreter.  An explicit "
            "Executor.run(compiled=...) argument overrides it")
define_flag("log_recompiles", False,
            "warn (RuntimeWarning) whenever the Executor misses its "
            "cache for a program that already reached steady state (had "
            "a cache hit): a feed shape/dtype or a run-time flag changed "
            "on the hot path.  Counted unconditionally in "
            "Executor.cache_stats()['recompiles_after_warmup']")
define_flag("remat", False,
            "default rematerialization for model builders that accept "
            "remat=None: the transformer encoder and decoder and the "
            "ResNets wrap each block in layers.recompute, whose "
            "activations are re-run in the backward instead of kept.  "
            "Read at BUILD time; never applied to a pipeline build")
define_flag("serving_kv_dtype", "",
            "default KV-pool storage precision for "
            "models.transformer.build_lm_paged_decoder when the caller "
            "passes kv_dtype=None: '' or 'fp32' = float32 blocks; "
            "'bf16' = bfloat16 blocks (half the resident KV bytes); "
            "'int8' = int8 blocks with one float32 scale per "
            "(layer, block), quantize-on-write / dequantize-in-kernel "
            "(~4x fewer resident bytes than fp32).  Read at BUILD time; "
            "the model-dir spec's kv_dtype and explicit builder/server "
            "args override it")
define_flag("serving_kernels", "auto",
            "serving-kernel selection (kernels/registry.py): 'auto' "
            "(default) arms the hand-written CUDA kernels for a decoder "
            "placed on a CUDA device; 'on' arms them everywhere (a "
            "decoder on the CPU then records the counted reason "
            "'no_cuda' and runs the plain PyTorch version); 'off' keeps "
            "the plain version.  Env alias PADDLE_TPU_SERVING_KERNELS.  "
            "Read at BUILD time by build_lm_paged_decoder, by "
            "ParallelExecutor for the fused bucket update (at build and "
            "at its first run after a change), and by the moe_ffn op for "
            "gate + dispatch at every call")
define_flag("overlap_bucket_bytes", 4 << 20,
            "size cap (bytes) for the compute/collective-overlap "
            "gradient buckets of ParallelExecutor(overlap='bucketed'|"
            "'auto'): parameter gradients are concatenated in "
            "production (backward) order into buckets of at most this "
            "many bytes, one stream per dtype, and each bucket gets ONE "
            "asynchronous all-reduce issued as soon as its last "
            "gradient is produced, so early buckets' all-reduces "
            "overlap the remaining backward (DDP-style).  0 puts every "
            "gradient in its own bucket.  Read when the executor is "
            "built, and again at its first run after a change")
define_flag("memory_optimize", False,
            "whole-program memory optimization "
            "(memory_optimization_transpiler): the interpreted and "
            "segmented modes run a cached clone of the Program through "
            "the liveness rename pass (buffer reuse), the current feed "
            "and fetch lists skipped, and drop each dead local-scope "
            "value after its last op (at segment granularity in the "
            "segmented mode); ParallelExecutor drops a step's dead "
            "values the same way.  The compiled mode drops every value "
            "after its last reader whatever the flag.  The rename "
            "re-keys the random streams of renamed temporaries: the "
            "same distribution, other draws than the unrenamed "
            "Program's")
define_flag("serving_spec_k", 4,
            "default speculative-decoding draft length: how many tokens "
            "the draft model proposes per scheduler tick for the target "
            "to verify in ONE step_window call.  Used when a "
            "GenerationServer is given a draft model without an "
            "explicit spec_k; greedy outputs stay bit-identical for "
            "any k")
define_flag("prefetch_depth", 0,
            "default Trainer.train prefetch depth: N > 0 runs reader + "
            "DataFeeder.feed + the host-to-device copy N batches ahead "
            "on a background thread (reader/pipeline.py); 0 keeps the "
            "serial loop.  Per-call override: Trainer.train(prefetch=N)")
define_flag("sync_every_n", 1,
            "default Trainer.train fetch-sync cadence: K > 1 hands "
            "EndIteration a LazyFetch cost (device->host copy deferred "
            "until read) and fences the dispatch queue every K steps; "
            "1 materializes every step (the serial loop).  Per-call "
            "override: Trainer.train(sync_every_n=K)")
define_flag("verify", "off",
            "static program verification before execution "
            "(paddle_tpu_torch.analysis, docs/analysis.md): 'off' = "
            "skip; 'warn' = run the analyzer in Executor.run / "
            "ParallelExecutor / io.load_inference_model and warn on "
            "findings; 'error' = additionally raise "
            "ProgramVerificationError on error-severity diagnostics.  "
            "Cached per program version")
