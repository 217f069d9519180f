"""Paged-attention decode: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py
`_decode_kernel`.  The kernel (csrc/paged_attention.cu) reads K/V blocks
straight from the pool through each slot's block table and computes
masked softmax attention of W query rows over positions
<= positions[s] + row, in float32, dequantizing as it reads (bf16 cast /
int8 x per-(layer, block) scale).  It is bound by bytes: every needed K
and V row is read once per (slot, layer) and no logical-order copy of
the pool is made.  Its grid splits each slot's context into runs of
`split_len_for(context)` positions, one CTA each; the last CTA of a
(head, slot) merges the runs in order, so one call is one launch and a
slot's result is the same bits from call to call.  W = 1 is the decode
step; W > 1 is `step_window` (chunked prefill and speculative verify).

`paged_attention` launches the kernel for CUDA tensors and runs
`paged_attention_reference` for CPU tensors; a CUDA call the kernel
cannot take raises.  Selection for the paged decoder goes through
kernels/registry.py ("paged_attention_decode").

Pools keep the JAX package's layout: [n_layers, num_blocks, block_size,
d_model] float32 or bfloat16 tensors, or for int8 a (payload int8, scales
float32 [n_layers, num_blocks]) tuple.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import math
import threading
from typing import Optional

import torch

from .registry import register_kernel

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_attention_supports", "build_paged_attention",
           "split_len_for", "SUPPORTED_HEAD_DIMS",
           "SOURCE"]

SOURCE = "paged_attention.cu"
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the kernel's shared memory per CTA must fit Hopper's 227 KB
_MAX_SMEM_BYTES = 232448

_count_lock = threading.Lock()
_lib = None
# (device index, stream) -> (merge counters, partials scratch)
_workspaces = {}


def _split_pool(pool):
    """-> (payload, scales or None)."""
    if isinstance(pool, (tuple, list)):
        return pool[0], pool[1]
    return pool, None


def _gather(pool, layer, tables):
    """Dequantized [S, NB, BS, D] float32 view through the table."""
    payload, scales = _split_pool(pool)
    blocks = payload[layer][tables.long()].float()
    if scales is not None:
        blocks = blocks * scales[layer][tables.long()][:, :, None, None]
    return blocks


def paged_attention_reference(q, pool_k, pool_v, tables, positions, layer,
                              *, n_heads: int):
    """The plain version: gather through the table, dequantize, then
    einsum + mask + softmax + einsum (the JAX package's gather branch,
    models/transformer.py step/step_window).  q [S, W, D] float32 ->
    [S, W, D] float32."""
    s_n, w_n, d_model = q.shape
    d_head = d_model // n_heads
    kh = _gather(pool_k, layer, tables)
    ctx_len = kh.shape[1] * kh.shape[2]
    kh = kh.reshape(s_n, ctx_len, n_heads, d_head)
    vh = _gather(pool_v, layer, tables).reshape(s_n, ctx_len, n_heads,
                                                d_head)
    qh = q.reshape(s_n, w_n, n_heads, d_head)
    sc = torch.einsum("bqhd,bshd->bqhs", qh, kh) * (1.0 / math.sqrt(d_head))
    pos_w = (positions.long()[:, None]
             + torch.arange(w_n, device=q.device)[None, :])
    keep = (torch.arange(ctx_len, device=q.device)[None, None, :]
            <= pos_w[:, :, None])                               # [S, W, L]
    sc = sc.masked_fill(~keep[:, :, None, :], float("-inf"))
    w_att = torch.softmax(sc, dim=-1)
    ctxh = torch.einsum("bqhs,bshd->bqhd", w_att, vh)
    return ctxh.reshape(s_n, w_n, d_model)


def split_len_for(ctx_len: int) -> int:
    """Positions per split of the kernel's split-KV grid, from the context
    length alone (so a slot's result never depends on the batch): 64,
    four 16-position tiles (at the serving shape, context 512, that is
    about 290 CTAs for 8 slots x 8 heads); 128 once a context would need
    more than 64 splits of 64, to keep the merge short."""
    return 64 if int(ctx_len) <= 64 * 64 else 128


def _library():
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load_library(SOURCE)
        fn = lib.paged_attention_decode
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.paged_attention_decode_smem
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def build():
    """Build (or load) the kernel library; returns nothing.  The first
    CUDA call builds it anyway — this lets a caller pay the build up
    front."""
    _library()


# what one call's checks settle, for the launch: everything but q,
# tables, positions and the layer
_Prepared = collections.namedtuple(
    "_Prepared", "fn k_ptr v_ptr ks_ptr vs_ptr ints n_layers split_len "
                 "n_split d_head scale kv_code")


def _prepare(q, pool_k, pool_v, tables, positions, *,
             n_heads: int) -> _Prepared:
    """Every check of a CUDA call except the layer's range; raises on a
    call the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    k_pay, k_sc = _split_pool(pool_k)
    v_pay, v_sc = _split_pool(pool_v)
    if q.dtype != torch.float32 or q.dim() != 3 or not q.is_contiguous():
        raise ValueError("paged_attention: q must be a contiguous float32 "
                         f"[S, W, D] tensor, got {q.dtype} {tuple(q.shape)}")
    s_n, w_n, d_model = q.shape
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by {n_heads} heads")
    d_head = d_model // n_heads
    if d_head not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention: d_head {d_head} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if k_pay.dtype not in _KV_CODES or v_pay.dtype != k_pay.dtype:
        raise ValueError("paged_attention: pools must share one dtype of "
                         f"{list(_KV_CODES)}, got {k_pay.dtype}/{v_pay.dtype}")
    quantized = k_pay.dtype == torch.int8
    if quantized != (k_sc is not None) or quantized != (v_sc is not None):
        raise ValueError("paged_attention: int8 pools come as (payload, "
                         "scales) tuples, float pools as bare tensors")
    n_layers, nb_pool, bs, pd = k_pay.shape
    if v_pay.shape != k_pay.shape or pd != d_model:
        raise ValueError(f"paged_attention: pool shapes {tuple(k_pay.shape)}"
                         f"/{tuple(v_pay.shape)} vs d_model {d_model}")
    if tables.dim() != 2 or tables.shape[0] != s_n:
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)} "
                         f"for {s_n} slots")
    nb = tables.shape[1]
    if positions.shape != (s_n,):
        raise ValueError(f"paged_attention: positions "
                         f"{tuple(positions.shape)} for {s_n} slots")
    tensors = [q, k_pay, v_pay, tables, positions]
    if quantized:
        tensors += [k_sc, v_sc]
        for sc in (k_sc, v_sc):
            if sc.dtype != torch.float32 or sc.shape != (n_layers, nb_pool):
                raise ValueError("paged_attention: int8 scales must be "
                                 f"float32 [{n_layers}, {nb_pool}]")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("paged_attention: all tensors must be on "
                             f"{q.device}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention: inputs must be contiguous")
    for t in (tables, positions):
        if t.dtype != torch.int32:
            raise ValueError("paged_attention: tables and positions must "
                             f"be int32, got {t.dtype}")
    # the kernel copies the pools in 16-byte chunks
    if k_pay.data_ptr() % 16 or v_pay.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned")
    ctx_len = nb * bs
    split_len = split_len_for(ctx_len)
    lib = _library()
    code = _KV_CODES[k_pay.dtype]
    if lib.paged_attention_decode_smem(w_n, d_head, split_len,
                                       code) > _MAX_SMEM_BYTES:
        raise ValueError(f"paged_attention: window {w_n} x split "
                         f"{split_len} exceeds the kernel's shared memory")
    return _Prepared(
        lib.paged_attention_decode, k_pay.data_ptr(), v_pay.data_ptr(),
        k_sc.data_ptr() if quantized else None,
        v_sc.data_ptr() if quantized else None,
        (s_n, w_n, d_model, n_heads, nb, bs, nb_pool), n_layers, split_len,
        -(-ctx_len // split_len), d_head, 1.0 / math.sqrt(d_head), code)


def _raw_stream(index: int) -> int:
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


def _workspace(index: int, stream: int, n_counters: int, n_floats: int):
    """(counters, scratch) of at least these sizes for launches on this
    device and stream: the merge tickets, zero before every launch
    (each launch leaves them zero), and the splits' partials.  Launches
    on one stream run in order, so they share them safely."""
    key = (index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_counters or \
            ws[1].numel() < n_floats:
        dev = torch.device("cuda", index)
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.zeros(max(n_counters, old[0]), dtype=torch.int32,
                          device=dev),
              torch.empty(max(n_floats, old[1]), dtype=torch.float32,
                          device=dev))
        _workspaces[key] = ws
    return ws


def _launch(prep: _Prepared, q, tables, positions, layer):
    if not 0 <= int(layer) < prep.n_layers:
        raise ValueError(f"paged_attention: layer {layer} of "
                         f"{prep.n_layers}")
    s_n, w_n, _, n_heads = prep.ints[:4]
    parts = s_n * n_heads * prep.n_split * w_n
    index = q.device.index
    out = torch.empty_like(q)
    guard = (torch.cuda.device(index) if index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        stream = _raw_stream(index)
        counters, scratch = _workspace(index, stream, s_n * n_heads,
                                       parts * (prep.d_head + 2))
        acc = scratch.data_ptr()
        rc = prep.fn(
            q.data_ptr(), prep.k_ptr, prep.v_ptr, prep.ks_ptr, prep.vs_ptr,
            tables.data_ptr(), positions.data_ptr(), out.data_ptr(), acc,
            acc + 4 * parts * prep.d_head, counters.data_ptr(), *prep.ints,
            int(layer), prep.split_len, prep.scale, prep.kv_code, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_decode launch failed: CUDA "
                           f"error {rc}")
    with _count_lock:
        paged_attention.launches += 1
    return out


def paged_attention(q, pool_k, pool_v, tables, positions, layer, *,
                    n_heads: int):
    """Paged-attention decode.  q [S, W, D] float32, pools as in the
    module docstring, tables [S, NB] int32, positions [S] int32 ->
    context [S, W, D] float32.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (one launch per call) or raise."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool_k, pool_v, tables,
                                         positions, layer, n_heads=n_heads)
    prep = _prepare(q, pool_k, pool_v, tables, positions, n_heads=n_heads)
    return _launch(prep, q, tables, positions, layer)


paged_attention.launches = 0


def paged_attention_supports(*, d_model: int, n_heads: int,
                             kv_dtype: str, window: int = 1,
                             platform: str = "cpu", **_) -> Optional[str]:
    """None when the decode shape runs on the CUDA kernel, else a short
    reason (the {kernel,reason} counter label)."""
    if kv_dtype not in ("fp32", "bf16", "int8"):
        return "kv_dtype"
    if d_model % n_heads:
        return "head_split"
    if int(window) < 1:
        return "window"
    if d_model // n_heads not in SUPPORTED_HEAD_DIMS:
        return "d_head"
    if platform != "cuda":
        return "no_cuda"
    return None


@register_kernel("paged_attention_decode", paged_attention_supports)
def build_paged_attention(*, n_heads: int, **_):
    """-> attend(q, pool_k, pool_v, tables, positions, layer), the
    kernel wrapper bound to the decoder's head count."""

    def attend(q, pool_k, pool_v, tables, positions, layer):
        return paged_attention(q, pool_k, pool_v, tables, positions, layer,
                               n_heads=n_heads)

    return attend
