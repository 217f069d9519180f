"""Continuous-batching generation server over the paged KV-cache.

Counterpart of paddle_tpu/serving/generation.py, serving the PyTorch
paged decoder (models/transformer.build_lm_paged_decoder) on a CUDA
device by default.  A closed-batch decode loop serves everyone together
and a new request waits for the whole batch to drain;
`GenerationServer` replaces that with the vLLM-style in-flight
schedule:

* ONE resident decode step (build_lm_paged_decoder) runs per tick over
  the active slot set — a single device dispatch per token position;
* BETWEEN ticks the scheduler admits queued requests into free slots
  (prefill is folded into the same per-token step: a just-admitted
  sequence is teacher-forced through its prompt positions while
  everyone else decodes), evicts finished sequences IMMEDIATELY and
  returns their KV blocks to the pool;
* admission is keyed to free KV blocks (a request is admitted only
  when its whole prompt+max_new budget fits, so decode can never hit
  an out-of-pool condition mid-sequence), queued requests past their
  deadline are shed at dequeue, and a full queue rejects with
  ServerSaturated at submit;
* every request streams tokens through its own `GenerationStream`
  future, and per-request numerics are bit-identical to running the
  same prompt alone (slot math is independent of batch composition —
  tests/test_generation_serving.py pins this);
* `swap_states` performs the zero-downtime checkpoint hot swap: stop
  admitting, let active sequences drain, swap parameters, resume —
  queued requests wait instead of failing.

`static_batch=True` degrades the scheduler to the drain-then-refill
baseline (admit only into an EMPTY active set) — same step, same
numerics.

On top ride the two algorithmic serving optimizations:

* PREFIX CACHING (`prefix_cache=True`, default): admission allocates
  through `PagedKVCache.allocate_prefix`, which shares fully-filled
  prompt blocks already resident from an earlier sequence with the
  same prompt prefix — the cursor then STARTS past the shared
  positions, skipping their prefill ticks entirely.  K/V at a position
  is a deterministic function of the token prefix, so shared blocks
  hold exactly what this sequence's prefill would have written:
  greedy output stays bit-identical to a cold run.
* SPECULATIVE DECODING (`draft_decoder`/`draft_states`, optional): a
  small draft model proposes `spec_k` greedy tokens per tick and the
  target verifies the whole window in ONE `step_window` dispatch.  The
  accept rule is the greedy degenerate of accept/resample — keep
  proposals while they equal the target's own argmax chain, then emit
  the target's next token as the bonus — so the emitted stream is the
  target's greedy output BY CONSTRUCTION; a tick delivers between 1
  and spec_k+1 tokens.  The draft keeps its own KV pool indexed by the
  SAME block tables (admission accounts blocks once; prefix hits warm
  both pools).  Sampled (temperature>0) requests take the plain
  one-token path — their per-(seed, position) PRNG contract is
  untouched.  Prefill is chunked through the same window step
  (spec_k+1 prompt positions per tick) when a draft is armed.

The model directory format (`generation.json` + npz parameters) is the
JAX package's, so a directory written by either package serves in the
other.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.executor import resolve_place
from ..core.resilience import (fault_injector,
                               sched_fault_armed as _sched_fault)
from ..kernels.cuda_build import build_counts
from ..observability import attribution as obs_attr
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from .batching import RequestDeadlineExceeded, ServerSaturated
from .kv_cache import KVPoolExhausted, PagedKVCache

__all__ = ["GenerationServer", "GenerationStream",
           "save_generation_model", "load_generation_model",
           "server_from_model_dir"]

MODEL_SPEC_FILENAME = "generation.json"
MODEL_PARAMS_FILENAME = "generation_params.npz"
MODEL_DRAFT_PARAMS_FILENAME = "generation_draft_params.npz"

_SERVER_IDS = itertools.count()
# stats()-backing series are always=True (the stats contract predates
# the PADDLE_TPU_METRICS switch); latency/depth series are gated.
_M_REQUESTS = obs_metrics.counter(
    "paddle_tpu_serving_generation_requests_total",
    "generation requests admitted to a decode slot", ("server",),
    always=True)
_M_TOKENS = obs_metrics.counter(
    "paddle_tpu_serving_generated_tokens_total",
    "generated tokens delivered to request streams", ("server",),
    always=True)
_M_TICKS = obs_metrics.counter(
    "paddle_tpu_serving_decode_ticks_total",
    "resident decode steps dispatched (tokens/tick = active slots)",
    ("server",), always=True)
_M_SHED = obs_metrics.counter(
    "paddle_tpu_serving_generation_shed_total",
    "requests shed instead of decoded, by reason "
    "(saturated: full queue at submit; deadline: expired while queued)",
    ("server", "reason"), always=True)
_M_SWAPS = obs_metrics.counter(
    "paddle_tpu_serving_hot_swaps_total",
    "zero-downtime checkpoint hot swaps completed", ("server",),
    always=True)
_M_LATENCY = obs_metrics.histogram(
    "paddle_tpu_serving_generation_seconds",
    "submit -> last-token wall latency per request", ("server",))
_M_TTFT = obs_metrics.histogram(
    "paddle_tpu_serving_first_token_seconds",
    "submit -> first generated token wall latency", ("server",))
_M_ACTIVE = obs_metrics.gauge(
    "paddle_tpu_serving_active_sequences",
    "sequences currently holding a decode slot", ("server",))
_M_QDEPTH = obs_metrics.gauge(
    "paddle_tpu_serving_generation_queue_depth",
    "requests waiting for admission", ("server",))
_M_DRAFT_PROPOSED = obs_metrics.counter(
    "paddle_tpu_serving_draft_proposed_total",
    "draft-model tokens proposed for target verification "
    "(speculative decoding)", ("server",), always=True)
_M_DRAFT_ACCEPTED = obs_metrics.counter(
    "paddle_tpu_serving_draft_accepted_total",
    "draft proposals accepted by the target's verify step "
    "(accept rate = accepted / proposed)", ("server",), always=True)


class GenerationStream:
    """Per-request streaming future: tokens arrive as the scheduler
    delivers them; `result()` blocks for the full generation.

    for tok in stream:            # streams tokens as they are decoded
        ...
    ids = stream.result()         # or: block until finished

    A failed request raises from both paths; a shed request raises the
    shed error (RequestDeadlineExceeded)."""

    def __init__(self, prompt: Sequence[int], max_new: int):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._done = False
        self._exc: Optional[BaseException] = None
        self._watchers = 0

    # -- scheduler side -----------------------------------------------------
    def _put(self, tok: int):
        with self._cond:
            self._tokens.append(int(tok))
            # wake waiters per token only when a live iterator streams
            # this request; result()-style waiters block on `done` and
            # a wakeup per token is pure GIL churn on the decode path
            # (it measurably dilutes the continuous-batching win)
            if self._watchers:
                self._cond.notify_all()

    def _finish(self):
        with self._cond:
            self._done = True
            self._cond.notify_all()

    def _fail(self, exc: BaseException):
        with self._cond:
            if not self._done:
                self._exc = exc
                self._done = True
                self._cond.notify_all()

    # -- client side --------------------------------------------------------
    @property
    def done(self) -> bool:
        with self._cond:
            return self._done

    def tokens_so_far(self) -> List[int]:
        with self._cond:
            return list(self._tokens)

    def __iter__(self):
        if _sched_fault("stream.yield-under-lock"):
            # the historical bug, reintroducible ONLY for the schedule
            # checker's regression pin (tests/test_torch_concurrency_
            # analysis.py): yielding with the lock held lets a slow
            # consumer stall the scheduler's _put
            yield from self._iter_yield_under_lock()
            return
        i = 0
        with self._cond:
            self._watchers += 1
        try:
            while True:
                # snapshot under the lock, yield OUTSIDE it: a consumer
                # that processes tokens slowly (a replica writing to a
                # slow TCP client) must never block the scheduler's
                # _put — that would stall every other request's decode
                with self._cond:
                    self._cond.wait_for(
                        lambda: self._done or len(self._tokens) > i)
                    batch = self._tokens[i:]
                    done = self._done  # final: no tokens arrive after
                    exc = self._exc
                for tok in batch:
                    yield tok
                i += len(batch)
                if done:
                    if exc is not None:
                        raise exc
                    return
        finally:
            with self._cond:
                self._watchers -= 1

    def _iter_yield_under_lock(self):
        i = 0
        with self._cond:
            self._watchers += 1
            try:
                while True:
                    self._cond.wait_for(
                        lambda: self._done or len(self._tokens) > i)
                    while i < len(self._tokens):
                        yield self._tokens[i]   # lock HELD across yield
                        i += 1
                    if self._done:
                        if self._exc is not None:
                            raise self._exc
                        return
            finally:
                self._watchers -= 1

    def result(self, timeout: Optional[float] = None) -> List[int]:
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError("generation still running")
            if self._exc is not None:
                raise self._exc
            return list(self._tokens)


class _Seq:
    """Scheduler-internal state of one admitted request."""

    __slots__ = ("stream", "tokens", "prompt_len", "max_new", "eos_id",
                 "temperature", "seed", "cur", "slot", "emitted",
                 "t_submit", "t_submit_wall", "expires", "trace_ctx",
                 "draft_next", "prompt_keys")

    def __init__(self, stream, max_new, eos_id, temperature, seed,
                 expires, trace_ctx):
        self.stream = stream
        self.tokens = list(stream.prompt)
        self.prompt_len = len(stream.prompt)
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.seed = int(seed) & 0xFFFFFFFF
        self.cur = 0
        self.slot = -1
        self.emitted = 0
        self.t_submit = time.perf_counter()
        self.t_submit_wall = time.time()
        self.expires = expires
        self.trace_ctx = trace_ctx
        # next position the DRAFT model's KV is missing (speculative
        # decoding: the draft trails the target by at most one
        # position after a fully-accepted window)
        self.draft_next = 0
        # chained prefix-cache block keys, computed ONCE at submit
        # (the scheduler re-checks a blocked queue head every tick)
        self.prompt_keys = None

    @property
    def positions_needed(self) -> int:
        # the cursor writes K/V at positions 0 .. prompt+max_new-2 (the
        # final emitted token is delivered, never re-attended)
        return self.prompt_len + self.max_new - 1


class GenerationServer:
    """Continuous-batching decode scheduler over one paged decoder.

    decoder/states: a models/transformer.build_lm_paged_decoder bundle
    plus its trained parameter dict (name -> numpy array or tensor;
    names must match decoder.state_names — same unique-name discipline
    as the Program builders).  `slots` bounds concurrent sequences,
    `kv_blocks` is the preallocated pool budget shared by ALL of them.
    `place` defaults to CUDAPlace(0) and raises with no CUDA device;
    the decoder (and draft) must have been built for the same device.
    """

    def __init__(self, decoder, states, *, slots: int = 8,
                 kv_blocks: int = 64, max_queue: int = 256,
                 place=None, static_batch: bool = False,
                 idle_poll_s: float = 0.005,
                 prefix_cache: bool = True,
                 draft_decoder=None, draft_states=None,
                 spec_k: Optional[int] = None):
        from ..core import flags as core_flags
        from ..models.transformer import states_from_reference

        self._device = resolve_place(place)
        for who, dec in (("target", decoder), ("draft", draft_decoder)):
            if dec is not None and dec.device != self._device:
                raise ValueError(
                    f"{who} decoder was built for {dec.device}, the "
                    f"server runs on {self._device} — build it with the "
                    "same place")
        if (draft_decoder is None) != (draft_states is None):
            raise ValueError(
                "speculative decoding needs BOTH draft_decoder and "
                "draft_states (or neither)")
        if draft_decoder is not None:
            if (draft_decoder.block_size != decoder.block_size
                    or draft_decoder.max_blocks_per_seq
                    != decoder.max_blocks_per_seq):
                raise ValueError(
                    "draft decoder block geometry "
                    f"({draft_decoder.block_size}x"
                    f"{draft_decoder.max_blocks_per_seq}) must match "
                    f"the target ({decoder.block_size}x"
                    f"{decoder.max_blocks_per_seq}) — both pools are "
                    "indexed by the SAME per-sequence block tables")
            if draft_decoder.vocab_size != decoder.vocab_size:
                raise ValueError("draft/target vocab_size mismatch")
        self._decoder = decoder
        self._draft = draft_decoder
        self._spec_k = int(spec_k
                           if spec_k is not None
                           else core_flags.get_flag("serving_spec_k"))
        if draft_decoder is not None and self._spec_k < 1:
            raise ValueError("spec_k must be >= 1 with a draft model")
        self._slots = int(slots)
        self._static = bool(static_batch)
        self._idle_poll_s = float(idle_poll_s)
        self._states = states_from_reference(states, decoder, self._device,
                                             who="target")
        sid = self._sid = str(next(_SERVER_IDS))
        bpb = getattr(decoder, "bytes_per_block", 0)
        if draft_decoder is not None:
            bpb += getattr(draft_decoder, "bytes_per_block", 0)
        self._cache = PagedKVCache(
            kv_blocks, decoder.block_size, decoder.max_blocks_per_seq,
            server_label=f"gen{sid}", prefix_cache=prefix_cache,
            bytes_per_block=bpb)
        # int8 pools cannot share a prompt's FINAL block: the
        # block-aligned full-prompt hit re-runs the last prompt
        # position, and an int8 write RE-QUANTIZES the whole shared
        # block in place — mutating bytes other live sequences attend
        # to.  fp32 and bf16 writes touch only their own (block,
        # offset) slot with byte-identical values (decode is
        # deterministic in the prefix), so they keep full sharing;
        # for int8 the submit-time keys drop the last prompt token,
        # which excludes exactly the aligned final block.
        self._kv_int8 = (
            getattr(decoder, "kv_dtype", "fp32") == "int8"
            or (draft_decoder is not None
                and getattr(draft_decoder, "kv_dtype", "fp32")
                == "int8"))
        # +1: device block 0 is the reserved null/scratch block
        self._pool_k, self._pool_v = decoder.init_pool(
            kv_blocks + 1, self._device)
        if draft_decoder is not None:
            self._draft_states = states_from_reference(
                draft_states, draft_decoder, self._device, who="draft")
            self._dpool_k, self._dpool_v = draft_decoder.init_pool(
                kv_blocks + 1, self._device)

        self._active: List[Optional[_Seq]] = [None] * self._slots
        self._tables = np.zeros(
            (self._slots, decoder.max_blocks_per_seq), np.int32)
        self._queue: deque = deque()
        self._max_queue = int(max_queue)
        self._lock = threading.Condition()
        self._stop = False
        self._draining = False
        self._pending_states = None
        self._swap_done = threading.Event()

        self._m_requests = _M_REQUESTS.labels(server=sid)
        self._m_tokens = _M_TOKENS.labels(server=sid)
        self._m_ticks = _M_TICKS.labels(server=sid)
        self._m_shed = _M_SHED.labels(server=sid, reason="saturated")
        self._m_deadline = _M_SHED.labels(server=sid, reason="deadline")
        self._m_swaps = _M_SWAPS.labels(server=sid)
        self._m_latency = _M_LATENCY.labels(server=sid)
        self._m_ttft = _M_TTFT.labels(server=sid)
        self._m_active = _M_ACTIVE.labels(server=sid)
        self._m_qdepth = _M_QDEPTH.labels(server=sid)
        self._m_proposed = _M_DRAFT_PROPOSED.labels(server=sid)
        self._m_accepted = _M_DRAFT_ACCEPTED.labels(server=sid)

        c0 = build_counts()
        t0 = time.perf_counter()
        self._warmup()
        c1 = build_counts()
        # kernel-build accounting (process-wide nvcc counters, diffed
        # around THIS warmup): nothing here is XLA-compiled; the CUDA
        # kernels build at first launch, which the warmup step makes, and
        # a build an earlier process left in kernels/_build is a hit
        self.warmup_stats = {
            "warmup_s": round(time.perf_counter() - t0, 4),
            "compiles": int(c1["compiles"] - c0["compiles"]),
            "compile_seconds": round(
                c1["compile_seconds"] - c0["compile_seconds"], 4),
            "cache_hits": int(c1["cache_hits"] - c0["cache_hits"]),
            "cache_misses": int(c1["cache_misses"]
                                - c0["cache_misses"]),
        }
        self._compiles_after_warmup_base = int(c1["compiles"])
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _warmup(self):
        """Run each resident step once before the first request (all
        slots inactive: writes land in the null block), so kernel
        builds and library set-up never happen inside a request's
        latency.  A speculative server runs the target's window step
        plus the draft's window and single steps; a plain server only
        the one-token step it runs."""
        z = np.zeros(self._slots, np.int32)
        zs = z.astype(np.uint32)
        zt = np.zeros(self._slots, np.float32)
        if self._draft is None:
            nxt, self._pool_k, self._pool_v = self._decoder.step(
                self._states, self._pool_k, self._pool_v, self._tables,
                z, z, zs, zt, np.zeros(self._slots, bool))
            nxt.cpu()  # block until the device has run the step
            return
        w = self._spec_k + 1
        zw = np.zeros((self._slots, w), np.int32)
        nxt, self._pool_k, self._pool_v = self._decoder.step_window(
            self._states, self._pool_k, self._pool_v, self._tables,
            z, zw, zs, zt, z)
        nxt.cpu()
        nxt, self._dpool_k, self._dpool_v = self._draft.step_window(
            self._draft_states, self._dpool_k, self._dpool_v,
            self._tables, z, zw, zs, zt, z)
        nxt.cpu()
        nxt, self._dpool_k, self._dpool_v = self._draft.step(
            self._draft_states, self._dpool_k, self._dpool_v,
            self._tables, z, z, zs, zt,
            np.zeros(self._slots, bool))
        nxt.cpu()

    # -- client side --------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> GenerationStream:
        """Enqueue one generation request; returns its token stream.

        Requests whose prompt+max_new budget can never fit a sequence's
        block-table capacity are rejected with ValueError up front; a
        full admission queue raises ServerSaturated (backpressure); a
        request still queued when `deadline_ms` passes is shed with
        RequestDeadlineExceeded instead of occupying a slot."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        stream = GenerationStream(prompt, max_new_tokens)
        expires = (time.monotonic() + deadline_ms / 1000.0
                   if deadline_ms is not None else None)
        seq = _Seq(stream, max_new_tokens, eos_id, temperature, seed,
                   expires, obs_tracing.current_context())
        need = self._cache.blocks_for(seq.positions_needed)
        if (need > self._cache.max_blocks_per_seq
                or seq.positions_needed > self._decoder.max_len):
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} "
                f"needs {need} KV blocks > per-sequence capacity "
                f"{self._cache.max_blocks_per_seq} "
                f"(block_size {self._cache.block_size})")
        if self._cache.prefix_cache:
            keyed = (prompt[:-1] if self._kv_int8 else prompt)
            seq.prompt_keys = self._cache.prompt_keys(keyed)
        with self._lock:
            if self._stop:
                raise RuntimeError("GenerationServer is closed")
            if self._draining:
                # retryable by contract: the replica front maps
                # RuntimeError to a non-fatal wire error, so a router
                # resubmits on a survivor — a draining replica sheds
                # ADMISSION, never an accepted request
                raise RuntimeError(
                    "GenerationServer is draining (graceful scale-in/"
                    "shutdown): submit on another replica")
            if len(self._queue) >= self._max_queue:
                self._m_shed.inc()
                raise ServerSaturated(
                    f"GenerationServer queue full ({self._max_queue} "
                    "pending) — backpressure: retry later or raise "
                    "max_queue")
            self._queue.append(seq)
            self._lock.notify_all()
        if obs_metrics.enabled():
            self._m_qdepth.set(len(self._queue))
        return stream

    def generate(self, prompt_ids, max_new_tokens: int,
                 timeout: Optional[float] = None, **kw) -> List[int]:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(prompt_ids, max_new_tokens, **kw).result(
            timeout)

    def swap_states(self, states: Dict[str, np.ndarray],
                    draft_states: Optional[Dict] = None,
                    wait: bool = True,
                    timeout: Optional[float] = None) -> bool:
        """Zero-downtime checkpoint hot swap: drain -> swap -> resume.

        Admission pauses, active sequences run to completion against
        the OLD parameters (a generation never mixes checkpoints),
        then the new parameters are installed and admission resumes.
        Queued requests are NOT failed — they wait out the drain.

        With a draft armed, pass the new checkpoint's `draft_states`
        too: a stale draft stays CORRECT (the target verifies every
        window) but its accept rate against the new target can
        collapse toward 1/vocab — a silent throughput regression.
        Omitting them keeps the old draft.  The new parameters are
        checked and copied to the device here, in the caller's thread."""
        from ..models.transformer import states_from_reference

        new = states_from_reference(states, self._decoder, self._device,
                                    who="swap")
        new_draft = None
        if draft_states is not None:
            if self._draft is None:
                raise ValueError(
                    "draft_states given but this server has no draft "
                    "armed (a draft cannot be armed mid-flight)")
            new_draft = states_from_reference(
                draft_states, self._draft, self._device, who="swap draft")
        with self._lock:
            if self._stop:
                raise RuntimeError("GenerationServer is closed")
            if self._pending_states is not None:
                raise RuntimeError("hot swap already in progress")
            self._swap_done.clear()
            self._pending_states = (new, new_draft)
            self._lock.notify_all()
        if wait:
            return self._swap_done.wait(timeout)
        return True

    # -- graceful drain (scale-in / SIGTERM) --------------------------------
    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def drain(self, wait: bool = True,
              timeout: Optional[float] = None) -> bool:
        """Stop ADMITTING new requests and (with `wait`) block until
        everything already accepted — active slots AND the queue — has
        run to completion.  This is the graceful-scale-in half of the
        hot-swap machinery: a drained replica has delivered every
        stream it ever accepted, so retiring it afterwards fails
        nothing.  New submits raise RuntimeError (retryable: a router
        resubmits on a survivor).  Returns True when fully drained
        within `timeout`; `resume()` re-opens admission for an aborted
        scale-in."""
        with self._lock:
            if self._stop:
                raise RuntimeError("GenerationServer is closed")
            self._draining = True
            self._lock.notify_all()
        if not wait:
            return True
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._lock:
            while not self._stop and (
                    self._queue
                    or any(s is not None for s in self._active)):
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                # the scheduler notifies on evictions; the short cap
                # also covers the error-eviction path, which doesn't
                self._lock.wait(timeout=min(0.05, left)
                                if left is not None else 0.05)
            return not self._stop

    def resume(self) -> None:
        """Re-open admission after drain() (an aborted scale-in: the
        at-least-one-replica invariant found no survivor to retire
        onto)."""
        with self._lock:
            self._draining = False
            self._lock.notify_all()

    def stats(self) -> Dict[str, float]:
        """Serving telemetry view (the JAX server's keys): request/token/
        tick counters, shed accounting, live occupancy, KV-pool state,
        prefix-cache hit accounting and speculative accept rates.
        `decode_kernel` is "cuda" or "plain:<reason>";
        `recompiles_after_warmup` counts kernel builds since warmup (in
        a one-server process any nonzero value is a build paid inside
        request latency); `warm_start` is always False — there is no
        warm-start artifact in this package."""
        with self._lock:
            active = sum(1 for s in self._active if s is not None)
            qdepth = len(self._queue)
            draining = self._draining
        recompiles = int(build_counts()["compiles"]
                         - self._compiles_after_warmup_base)
        out = {"requests": int(self._m_requests.value),
               "generated_tokens": int(self._m_tokens.value),
               "ticks": int(self._m_ticks.value),
               "shed": int(self._m_shed.value),
               "deadline_expired": int(self._m_deadline.value),
               "hot_swaps": int(self._m_swaps.value),
               "active_sequences": active,
               "queue_depth": qdepth,
               "kv_blocks_free": self._cache.free_blocks,
               "kv_blocks_total": self._cache.num_blocks,
               "kv_pool_utilization": self._cache.utilization(),
               "kv_dtype": getattr(self._decoder, "kv_dtype", "fp32"),
               "decode_kernel": self._decoder.kernels[
                   "paged_attention_decode"],
               "kv_bytes_resident": (self._cache.used_blocks
                                     * self._cache.bytes_per_block),
               "draft_proposed": int(self._m_proposed.value),
               "draft_accepted": int(self._m_accepted.value),
               "spec_k": self._spec_k if self._draft is not None else 0,
               "draining": draining,
               "recompiles_after_warmup": recompiles,
               "warm_start": False}
        out.update(self.warmup_stats)
        out.update(self._cache.prefix_stats())
        return out

    def outstanding_tokens(self) -> int:
        """Token budget not yet delivered (active + queued) — the load
        signal the replica router places on (least outstanding)."""
        with self._lock:
            out = sum(s.max_new - s.emitted
                      for s in self._active if s is not None)
            out += sum(s.max_new for s in self._queue)
        return out

    def close(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._worker.join(timeout=10)
        err = RuntimeError("GenerationServer closed")
        with self._lock:
            leftovers = ([s for s in self._active if s is not None]
                         + list(self._queue))
            self._active = [None] * self._slots
            self._queue.clear()
        for seq in leftovers:
            self._cache.release(seq)
            seq.stream._fail(err)
        self._cache.close()
        for fam in (_M_REQUESTS, _M_TOKENS, _M_TICKS, _M_SWAPS,
                    _M_LATENCY, _M_TTFT, _M_ACTIVE, _M_QDEPTH,
                    _M_DRAFT_PROPOSED, _M_DRAFT_ACCEPTED):
            fam.remove(server=self._sid)
        for reason in ("saturated", "deadline"):
            _M_SHED.remove(server=self._sid, reason=reason)
        # serving-kernel fallback series counted by this server's
        # decoders (kernels/registry.py Selection contract)
        for dec in (self._decoder, self._draft):
            sel = getattr(dec, "kernel_selection", None)
            if sel is not None:
                sel.close()

    # -- scheduler ----------------------------------------------------------
    def _shed_expired_locked(self, now: float) -> List[_Seq]:
        shed = []
        kept: deque = deque()
        for seq in self._queue:
            if seq.expires is not None and now >= seq.expires:
                shed.append(seq)
            else:
                kept.append(seq)
        self._queue = kept
        return shed

    def _admit_locked(self) -> List[_Seq]:
        """Move queued requests into free slots, FIFO, while KV blocks
        and slots last.  Head-of-line order is deliberate: skipping a
        big request to admit later small ones would starve it."""
        admitted = []
        n_active = sum(1 for s in self._active if s is not None)
        if self._static and n_active:
            return admitted   # drain-then-refill baseline
        if self._pending_states is not None:
            return admitted   # draining for a hot swap
        while self._queue:
            slot = next((i for i, s in enumerate(self._active)
                         if s is None), -1)
            if slot < 0:
                break
            seq = self._queue[0]
            if not self._cache.can_admit(seq.positions_needed,
                                         prompt_keys=seq.prompt_keys):
                break
            self._queue.popleft()
            try:
                with obs_attr.phase("generation", "kv_alloc"):
                    table, cached = self._cache.allocate_prefix(
                        seq, seq.positions_needed,
                        prompt_keys=seq.prompt_keys)
            except KVPoolExhausted:
                # can_admit/allocate_prefix disagreeing is a bug, but
                # an unserved admission must back off (head of queue,
                # retried next tick) — never kill the scheduler thread
                self._queue.appendleft(seq)
                break
            # prefix hit: the first `cached` positions already hold
            # this prompt's K/V — start the cursor there and skip
            # their prefill ticks.  A block-ALIGNED full-prompt hit
            # still re-runs the last prompt position (the step must
            # produce the first new token); that write lands in a
            # shared block with byte-identical values — the zero-copy
            # degenerate of copy-on-write.
            seq.cur = min(cached, seq.prompt_len - 1)
            seq.draft_next = seq.cur
            seq.slot = slot
            self._active[slot] = seq
            self._tables[slot] = table
            admitted.append(seq)
        return admitted

    def _evict_locked(self, seq: _Seq):
        self._active[seq.slot] = None
        self._tables[seq.slot] = 0
        seq.slot = -1
        with obs_attr.phase("generation", "kv_release"):
            self._cache.release(seq)

    def _loop(self):
        dec = self._decoder
        while True:
            with obs_attr.phase("generation", "admit"), self._lock:
                if self._stop:
                    return
                shed = self._shed_expired_locked(time.monotonic())
                admitted = self._admit_locked()
                seqs = [s for s in self._active if s is not None]
                swap = (self._pending_states
                        if self._pending_states is not None
                        and not seqs else None)
                qdepth = len(self._queue)
            metrics_on = obs_metrics.enabled()
            for seq in shed:
                self._m_deadline.inc()
                seq.stream._fail(RequestDeadlineExceeded(
                    "request deadline expired while queued for "
                    "admission"))
            if admitted:
                self._m_requests.inc(len(admitted))
            if metrics_on:
                self._m_qdepth.set(qdepth)
                self._m_active.set(len(seqs))
            if swap is not None:
                self._install_states(swap)
                continue
            if not seqs:
                with self._lock:
                    if (not self._queue and not self._stop
                            and self._pending_states is None):
                        self._lock.wait(timeout=self._idle_poll_s)
                continue
            try:
                # chaos hook fires inside _tick/_tick_spec, within the
                # attributed phase block: an error rule fails this
                # tick's sequences (they are evicted, their streams get
                # the error) but must never kill the scheduler thread
                if self._draft is None:
                    nxt = self._tick(seqs)
                else:
                    plans, preds = self._tick_spec(seqs)
            except Exception as e:
                with self._lock:
                    for seq in seqs:
                        self._evict_locked(seq)
                for seq in seqs:
                    seq.stream._fail(e)
                continue
            if self._draft is None:
                self._deliver(seqs, nxt, metrics_on)
            else:
                self._deliver_spec(plans, preds, metrics_on)
            # freshly-filled full prompt blocks become shareable the
            # moment the cursor passes their end (no-op once a
            # sequence has nothing pending or was evicted)
            for seq in seqs:
                self._cache.commit_prefix(seq, seq.cur)

    def _tick(self, seqs: List[_Seq]) -> np.ndarray:
        tokens = np.zeros(self._slots, np.int32)
        positions = np.zeros(self._slots, np.int32)
        temps = np.zeros(self._slots, np.float32)
        seeds = np.zeros(self._slots, np.uint32)
        active = np.zeros(self._slots, bool)
        for seq in seqs:
            tokens[seq.slot] = seq.tokens[seq.cur]
            positions[seq.slot] = seq.cur
            temps[seq.slot] = seq.temperature
            seeds[seq.slot] = seq.seed
            active[seq.slot] = True
        # attribution: dispatch is "prefill" while EVERY ticking
        # sequence is still teacher-forcing its prompt, else "decode"
        # (mixed ticks are decode work for at least one stream); the
        # host-side sync that materializes the sampled tokens is
        # "sample" — on an async backend that is where the device time
        # surfaces
        phase_name = ("prefill" if all(s.cur < s.prompt_len - 1
                                       for s in seqs) else "decode")
        with obs_tracing.span("serving.decode_tick", active=len(seqs)):
            with obs_attr.phase("generation", phase_name):
                fault_injector().fire("serving.decode")
                nxt, self._pool_k, self._pool_v = self._decoder.step(
                    self._states, self._pool_k, self._pool_v,
                    self._tables, positions, tokens, seeds, temps,
                    active)
            with obs_attr.phase("generation", "sample"):
                out = nxt.cpu().numpy()
        self._m_ticks.inc()
        return out

    def _deliver(self, seqs: List[_Seq], nxt: np.ndarray,
                 metrics_on: bool):
        now = time.perf_counter()
        delivered = 0
        finished = []
        with obs_attr.phase("generation", "deliver"):
            for seq in seqs:
                tok = int(nxt[seq.slot])
                seq.cur += 1
                if seq.cur < seq.prompt_len:
                    continue      # still prefilling: teacher-forced
                seq.tokens.append(tok)
                seq.emitted += 1
                delivered += 1
                if metrics_on and seq.emitted == 1:
                    with obs_tracing.activate(seq.trace_ctx):
                        self._m_ttft.observe(now - seq.t_submit)
                seq.stream._put(tok)
                if (seq.emitted >= seq.max_new
                        or (seq.eos_id is not None
                            and tok == seq.eos_id)):
                    finished.append(seq)
        if delivered:
            self._m_tokens.inc(delivered)
        if finished:
            with self._lock:
                for seq in finished:
                    self._evict_locked(seq)
                self._lock.notify_all()
            for seq in finished:
                self._finish_seq(seq, now, metrics_on)

    def _finish_seq(self, seq: _Seq, now: float, metrics_on: bool):
        """Close out a finished sequence: record the end-to-end
        ``serving.request`` span (child of the submitter's context, so
        router/replica hops join into one trace) and observe latency
        with that trace active — the histogram exemplar then points at
        this request's trace."""
        dur = now - seq.t_submit
        ctx = obs_tracing.record_span(
            "serving.request", seq.t_submit_wall, dur,
            parent=seq.trace_ctx, server=self._sid,
            tokens=seq.emitted) or seq.trace_ctx
        if metrics_on:
            with obs_tracing.activate(ctx):
                self._m_latency.observe(dur)
        seq.stream._finish()

    # -- speculative path ---------------------------------------------------
    def _tick_spec(self, seqs: List[_Seq]):
        """One speculative tick: draft catch-up + k greedy proposals
        per eligible slot, then ONE target step_window verifying the
        whole window.  Returns (plans, preds) for _deliver_spec.

        A plan is (seq, c, m, teacher, n_prop, proposals): `c` the
        cursor at tick start, `m` how many committed tokens sit at the
        window's head (teacher-forced), `n_prop` how many draft tokens
        follow them.  Sampled requests and prefill interiors get
        n_prop=0 — pure (chunked) teacher forcing."""
        w = self._spec_k + 1
        plans = []
        for seq in seqs:
            c = seq.cur
            m = len(seq.tokens) - c
            n_max = min(w, seq.positions_needed - c)
            teacher = min(m, n_max)
            greedy = seq.temperature == 0.0
            n_prop = (n_max - teacher
                      if greedy and teacher == m else 0)
            plans.append((seq, c, m, teacher, n_prop))

        # draft catch-up: teacher-force the draft over the window's
        # committed head so its KV tracks the target's (positions a
        # proposal step will re-write are excluded).  Normally one
        # chunk; the loop guards the at-most-one-position lag a fully
        # accepted window leaves behind.  Sampled sequences never
        # propose but STILL keep the draft warm: the prompt blocks
        # they commit to the prefix cache must hold valid draft KV for
        # the greedy sequences that later share them.
        with obs_attr.phase("generation", "draft_verify"):
            while True:
                todo = []
                for seq, c, m, teacher, n_prop in plans:
                    end = c + teacher - (1 if n_prop else 0)
                    if seq.draft_next < end:
                        todo.append(
                            (seq, min(end - seq.draft_next, w)))
                if not todo:
                    break
                pos = np.zeros(self._slots, np.int32)
                toks = np.zeros((self._slots, w), np.int32)
                nv = np.zeros(self._slots, np.int32)
                for seq, n in todo:
                    pos[seq.slot] = seq.draft_next
                    toks[seq.slot, :n] = seq.tokens[
                        seq.draft_next:seq.draft_next + n]
                    nv[seq.slot] = n
                _, self._dpool_k, self._dpool_v = \
                    self._draft.step_window(
                        self._draft_states, self._dpool_k,
                        self._dpool_v, self._tables, pos, toks,
                        np.zeros(self._slots, np.uint32),
                        np.zeros(self._slots, np.float32), nv)
                for seq, n in todo:
                    seq.draft_next += n

            # proposal micro-steps: the draft extends each eligible
            # slot greedily, one position per call, batched across
            # slots; step i feeds the committed frontier token first,
            # then its own previous proposal
            max_prop = max((p[4] for p in plans), default=0)
            proposals: Dict[object, List[int]] = {
                p[0]: [] for p in plans}
            for i in range(max_prop):
                pos = np.zeros(self._slots, np.int32)
                toks = np.zeros(self._slots, np.int32)
                act = np.zeros(self._slots, bool)
                stepping = []
                for seq, c, m, teacher, n_prop in plans:
                    if i >= n_prop:
                        continue
                    base = c + teacher - 1
                    pos[seq.slot] = base + i
                    toks[seq.slot] = (seq.tokens[base] if i == 0
                                      else proposals[seq][-1])
                    act[seq.slot] = True
                    stepping.append(seq)
                nxt, self._dpool_k, self._dpool_v = self._draft.step(
                    self._draft_states, self._dpool_k, self._dpool_v,
                    self._tables, pos, toks,
                    np.zeros(self._slots, np.uint32),
                    np.zeros(self._slots, np.float32), act)
                out = nxt.cpu().numpy()
                for seq in stepping:
                    proposals[seq].append(int(out[seq.slot]))
                    seq.draft_next = pos[seq.slot] + 1

        # ONE target dispatch verifies/extends every slot's window
        pos = np.zeros(self._slots, np.int32)
        toks = np.zeros((self._slots, w), np.int32)
        nv = np.zeros(self._slots, np.int32)
        temps = np.zeros(self._slots, np.float32)
        seeds = np.zeros(self._slots, np.uint32)
        for seq, c, m, teacher, n_prop in plans:
            window = seq.tokens[c:c + teacher] + proposals[seq]
            pos[seq.slot] = c
            toks[seq.slot, :len(window)] = window
            nv[seq.slot] = teacher + n_prop
            temps[seq.slot] = seq.temperature
            seeds[seq.slot] = seq.seed
        with obs_tracing.span("serving.decode_tick", active=len(seqs),
                              speculative=True):
            with obs_attr.phase("generation", "draft_verify"):
                fault_injector().fire("serving.decode")
                nxt, self._pool_k, self._pool_v = \
                    self._decoder.step_window(
                        self._states, self._pool_k, self._pool_v,
                        self._tables, pos, toks, seeds, temps, nv)
            with obs_attr.phase("generation", "sample"):
                preds = nxt.cpu().numpy()
        self._m_ticks.inc()
        full_plans = [(seq, c, m, teacher, n_prop, proposals[seq])
                      for seq, c, m, teacher, n_prop in plans]
        return full_plans, preds

    def _deliver_spec(self, plans, preds: np.ndarray, metrics_on: bool):
        """Greedy accept rule over each slot's verified window: keep
        emitting the target's prediction chain while it agrees with
        the next window token (committed tokens agree by construction;
        draft proposals are ACCEPTED on match), stop at the first
        disagreement with the target's own token as the bonus — the
        emitted stream is exactly the target's one-token-at-a-time
        greedy output."""
        now = time.perf_counter()
        delivered = 0
        proposed = accepted = 0
        finished = []
        with obs_attr.phase("generation", "deliver"):
            for seq, c, m, teacher, n_prop, props in plans:
                n_valid = teacher + n_prop
                window = seq.tokens[c:c + teacher] + props
                emitted: List[int] = []
                j_stop = n_valid - 1   # pure-teacher: no emission
                j = m - 1
                if j < n_valid:
                    while True:
                        tok = int(preds[seq.slot, j])
                        emitted.append(tok)
                        if (seq.emitted + len(emitted) >= seq.max_new
                                or (seq.eos_id is not None
                                    and tok == seq.eos_id)):
                            j_stop = j
                            break
                        if j + 1 < n_valid and tok == window[j + 1]:
                            j += 1   # proposal verified: keep going
                            continue
                        j_stop = j
                        break
                seq.cur = c + j_stop + 1
                proposed += n_prop
                if n_prop:
                    accepted += min(max(len(emitted) - 1, 0), n_prop)
                # the draft's KV is valid only where it processed
                # tokens that ended up committed — never past the
                # bonus token
                seq.draft_next = min(seq.draft_next, seq.cur)
                if emitted:
                    if metrics_on and seq.emitted == 0:
                        with obs_tracing.activate(seq.trace_ctx):
                            self._m_ttft.observe(now - seq.t_submit)
                    seq.tokens.extend(emitted)
                    seq.emitted += len(emitted)
                    delivered += len(emitted)
                    for tok in emitted:
                        seq.stream._put(tok)
                    if (seq.emitted >= seq.max_new
                            or (seq.eos_id is not None
                                and emitted[-1] == seq.eos_id)):
                        finished.append(seq)
        if delivered:
            self._m_tokens.inc(delivered)
        if proposed:
            self._m_proposed.inc(proposed)
        if accepted:
            self._m_accepted.inc(accepted)
        if finished:
            with self._lock:
                for seq in finished:
                    self._evict_locked(seq)
                self._lock.notify_all()
            for seq in finished:
                self._finish_seq(seq, now, metrics_on)

    def _install_states(self, pending):
        new, new_draft = pending
        # cached prefix K/V is keyed by token content alone and is
        # valid for exactly ONE parameter version: flush it, or
        # post-swap requests would skip prefill into the OLD
        # checkpoint's K/V and silently emit wrong tokens
        self._cache.flush_prefix()
        with self._lock:
            self._states = new
            if new_draft is not None:
                self._draft_states = new_draft
            self._pending_states = None
            self._lock.notify_all()
        self._m_swaps.inc()
        self._swap_done.set()


# -- model dir format --------------------------------------------------------

def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_generation_model(dirname: str, states: Dict[str, np.ndarray],
                          spec: Dict,
                          draft_states: Optional[Dict] = None) -> str:
    """Persist a generation model: `generation.json` (architecture
    spec: vocab_size/d_model/n_heads/n_layers/d_inner, plus optional
    serving defaults block_size/max_blocks_per_seq/slots/kv_blocks/
    kv_dtype/spec_k and an optional `draft` sub-spec) and one npz of
    parameters (numpy arrays or tensors).  With `draft_states`, the
    speculative-decoding draft model's parameters land in a second npz
    and spec["draft"] must name its architecture ({d_model, n_heads,
    n_layers[, d_inner]}; vocab and block geometry are shared with the
    target).  The format is the JAX package's."""
    os.makedirs(dirname, exist_ok=True)
    for key in ("vocab_size", "d_model", "n_heads", "n_layers"):
        if key not in spec:
            raise ValueError(f"spec missing {key!r}")
    if draft_states is not None:
        draft = spec.get("draft")
        if not isinstance(draft, dict):
            raise ValueError(
                "draft_states given but spec['draft'] (the draft "
                "architecture dict) is missing")
        for key in ("d_model", "n_heads", "n_layers"):
            if key not in draft:
                raise ValueError(f"spec['draft'] missing {key!r}")
        np.savez(os.path.join(dirname, MODEL_DRAFT_PARAMS_FILENAME),
                 **{n: _host(v) for n, v in draft_states.items()})
    with open(os.path.join(dirname, MODEL_SPEC_FILENAME), "w") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
    np.savez(os.path.join(dirname, MODEL_PARAMS_FILENAME),
             **{n: _host(v) for n, v in states.items()})
    return dirname


def load_generation_model(dirname: str, with_draft: bool = False):
    """-> (states, spec) saved by save_generation_model; with
    `with_draft=True`, -> (states, spec, draft_states_or_None)."""
    with open(os.path.join(dirname, MODEL_SPEC_FILENAME)) as f:
        spec = json.load(f)
    with np.load(os.path.join(dirname, MODEL_PARAMS_FILENAME)) as z:
        states = {n: z[n] for n in z.files}
    if not with_draft:
        return states, spec
    draft_states = None
    dpath = os.path.join(dirname, MODEL_DRAFT_PARAMS_FILENAME)
    if os.path.exists(dpath):
        with np.load(dpath) as z:
            draft_states = {n: z[n] for n in z.files}
    return states, spec, draft_states


def server_from_model_dir(dirname: str, *, block_size: Optional[int] = None,
                          max_blocks_per_seq: Optional[int] = None,
                          slots: Optional[int] = None,
                          kv_blocks: Optional[int] = None,
                          kv_dtype: Optional[str] = None,
                          spec_k: Optional[int] = None,
                          use_draft: bool = True,
                          place=None,
                          **kw) -> GenerationServer:
    """Build a GenerationServer from a saved model dir, on `place`
    (default CUDAPlace(0); raises with no CUDA device).

    Resets the framework unique-name counters to rebuild the decoder
    under the names the parameters were saved with — intended for
    fresh serving processes, not mid-session.  `kv_dtype` overrides the
    spec's pool precision; a model dir with draft params arms
    speculative decoding unless `use_draft=False`."""
    from ..core import framework as fw
    from ..models.transformer import build_lm_paged_decoder

    states, spec, draft_states = load_generation_model(
        dirname, with_draft=True)
    bs = int(block_size or spec.get("block_size", 16))
    nb = int(max_blocks_per_seq
             or spec.get("max_blocks_per_seq",
                         -(-int(spec.get("max_len", 256)) // bs)))
    kvd = kv_dtype or spec.get("kv_dtype")
    fw.reset_unique_names()
    _, decoder = build_lm_paged_decoder(
        spec["vocab_size"], bs, nb, d_model=spec["d_model"],
        n_heads=spec["n_heads"], n_layers=spec["n_layers"],
        d_inner=spec.get("d_inner"), kv_dtype=kvd, place=place)
    draft_decoder = None
    if draft_states is not None and use_draft:
        dspec = spec["draft"]
        fw.reset_unique_names()
        _, draft_decoder = build_lm_paged_decoder(
            spec["vocab_size"], bs, nb, d_model=dspec["d_model"],
            n_heads=dspec["n_heads"], n_layers=dspec["n_layers"],
            d_inner=dspec.get("d_inner"), kv_dtype=kvd, place=place)
    else:
        draft_states = None
    server = GenerationServer(
        decoder, states,
        slots=int(slots or spec.get("slots", 8)),
        kv_blocks=int(kv_blocks or spec.get("kv_blocks", 64)),
        draft_decoder=draft_decoder, draft_states=draft_states,
        spec_k=(spec_k if spec_k is not None else spec.get("spec_k")),
        place=place, **kw)
    _publish_static_decode_floor(spec, server)
    return server


def _publish_static_decode_floor(spec: dict, server: GenerationServer):
    """Publish the static roofline floor for the decode phase so the
    collector's calibration detector can band measured-vs-static
    (docs/observability.md "Time attribution"); publish_static_floor
    does nothing while metrics are off.  Best-effort: the cost model
    not covering a spec must never block serving."""
    try:
        from ..analysis.cost_model import (analyze_generation_spec,
                                           roofline_seconds,
                                           serving_kernel_cost)
        rows = analyze_generation_spec(
            spec, slots=server._slots)["kernels"]
        step = rows[0]
        # band against the backend the DECODER actually selected (the
        # registry's spec-level resolution can disagree with a build
        # that fell back on shape, or with the CPU place a caller asked
        # for) — the calibration ratio must compare measured time to
        # the floor of what runs, not of the plain path
        backend = ("cuda" if getattr(server._decoder, "kernels", {})
                   .get("paged_attention_decode") == "cuda"
                   else "plain")
        if step.get("backend") != backend:
            step = serving_kernel_cost(
                "paged_decode_step", spec, slots=server._slots,
                context=(int(spec.get("block_size", 16))
                         * int(spec.get("max_blocks_per_seq", 64)))
                // 2,
                kv_dtype=str(spec.get("kv_dtype") or "fp32"),
                backend=backend)
        obs_attr.publish_static_floor("generation", {
            "decode": roofline_seconds(step["flops"], step["bytes"]),
        })
    except Exception as e:
        warnings.warn(f"static decode floor unavailable: {e!r}")
