"""Flash attention: the CUDA kernels' wrappers and the plain version.

Replaces the TPU kernels of paddle_tpu/kernels/flash_attention.py —
`_fwd_kernel` (tiled attention with an online softmax, writing O and the
per-row logsumexp), `_dq_kernel` and `_dkv_kernel` (the recomputing
backward) — with csrc/flash_attention.cu.  The kernels are bound by
operations, and all three run every product on the tensor cores (3xTF32
for float32 inputs, bf16 with a hi + lo split of the float32 operand, P
or dS, for bfloat16); the source says how.  `_round_tf32`,
`_split_matmul` and `_bf16_split` model that product arithmetic on the
CPU for the tests.

`flash_attention(q, k, v, causal, scale)` on [batch, seq, heads,
head_dim] tensors is a `torch.autograd.Function`: its forward launches
the forward kernel (`flash_attention_fwd`) and saves q, k, v, o and the
logsumexp; its backward (`flash_attention_bwd`) computes delta =
rowsum(dO * O) in PyTorch (as the JAX package does outside its kernels)
and launches the dQ and dK/dV kernels (`flash_attention_dq`,
`flash_attention_dkv`).  The logsumexp also rides on the returned
tensor (`saved_lse(o)`), so the `flash_attention` op's gradient
(ops/attention.py) runs the backward without re-running the forward.
Each of the
three wrappers has its plain version beside it (`*_reference`, the same
function in plain PyTorch) and counts its launches in
`flash_attention.launches`.  A CPU (or meta) tensor runs the plain
versions — `flash_attention` runs `flash_attention_reference` under
autograd; a CUDA tensor launches the kernels or raises.
`flash_attention_supports` says which calls the kernels take; a CUDA
call they do not take raises.  The forward kernel is also the PyTorch
op `paddle_tpu_torch::flash_attention_fwd` (`flash_attention_fwd_op`),
which `flash_attention` takes while torch.export traces, so an exported
program (io.export_aot_model) launches the kernel after a reload.
Causal masking is top-left aligned: query row i sees key positions
0..i, also when seq_q != seq_k.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_supports", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_fwd_reference", "flash_attention_dq_reference",
           "flash_attention_dkv_reference", "flash_attention_bwd",
           "attention_delta", "saved_lse", "build",
           "flash_attention_fwd_op", "SUPPORTED_HEAD_DIMS", "SOURCE"]

SOURCE = "flash_attention.cu"
NEG_INF = -1e30  # the kernels' finite mask value
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_lib = None


def _scores(q, k, causal, scale):
    """Scaled float32 scores [b, h, sq, sk]; causal positions past the
    diagonal (top-left aligned) take the kernels' finite mask value."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = (torch.arange(q.shape[1], device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _scale(q, scale):
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """The forward kernel's plain version: -> (o in q's dtype, lse
    float32 [b, h, sq]), computed in float32 with materialized scores."""
    s = _scores(q, k, causal, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                     v.float())
    return o.to(q.dtype), lse


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Attention on [b, s, h, d] tensors: the plain version of
    `flash_attention` (differentiable by autograd)."""
    return flash_attention_fwd_reference(q, k, v, causal, scale)[0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """The backward kernels' shared math: P = exp(S - lse) and
    dS = P * (dO V^T - delta) * scale, float32 [b, h, sq, sk]."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_dq_reference(q, k, v, do, lse, delta, causal=False,
                                 scale=None):
    """The dQ kernel's plain version: dQ = dS K, in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q, scale))
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, causal=False,
                                  scale=None):
    """The dK/dV kernel's plain version: dK = dS^T Q, dV = P^T dO."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, _scale(q, scale))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _round_tf32(x):
    """float32 -> TF32 as `cvt.rna.tf32.f32` rounds it: to nearest, ties
    away from zero, on the low 13 mantissa bits (kept in float32)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_matmul(a, b, terms=3):
    """a @ b as the kernels' float32 products compute it on the
    tensor cores: each operand split into TF32 big = rna(x) and small =
    rna(x - big); terms=3 sums a_small b_big + a_big b_small + a_big b_big
    (3xTF32), terms=1 is one TF32 product a_big b_big.  The products are
    exact in float32, their sums float32."""
    a_big, b_big = _round_tf32(a), _round_tf32(b)
    out = a_big @ b_big
    if terms == 1:
        return out
    if terms != 3:
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    a_small = _round_tf32(a.float() - a_big)
    b_small = _round_tf32(b.float() - b_big)
    return a_small @ b_big + a_big @ b_small + out


def _bf16_split(x):
    """float32 -> (hi, lo) bfloat16 with hi + lo ~ x: how the bf16
    kernels feed P and dS (float32) to a bf16 product, as two."""
    hi = x.float().bfloat16()
    return hi, (x.float() - hi.float()).bfloat16()


def attention_delta(o, do):
    """delta = rowsum(dO * O), float32 [b, h, sq] like the logsumexp
    (the JAX package computes it outside its kernels too)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _shape_reason(q, k, v) -> Optional[str]:
    """Why the kernels cannot take these tensors, or None."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return "shape"
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        return "shape"
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return "dtype"
    if d not in SUPPORTED_HEAD_DIMS:
        return "d_head"
    return None


def flash_attention_supports(q, k, v) -> Optional[str]:
    """None when the CUDA kernels take this call, else a short reason:
    "no_cuda", "shape", "dtype" or "d_head"."""
    if q.device.type != "cuda":
        return "no_cuda"
    return _shape_reason(q, k, v)


def _library():
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load_library(SOURCE)
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = [i] * 5 + [ll] * 9 + [ctypes.c_float, i, i, vp]
        for name, n_ptrs in (("flash_attention_fwd", 5),
                             ("flash_attention_bwd_dq", 7),
                             ("flash_attention_bwd_dkv", 8)):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * n_ptrs + tail
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build():
    """Build (or load) the kernel library; the first CUDA call builds it
    anyway — this lets a caller pay the build up front."""
    _library()


def _aligned(x) -> bool:
    """Unit stride over head_dim, 16-byte aligned rows: what the
    kernels' 16-byte loads need."""
    per = 16 // x.element_size()
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s % per == 0 for s in x.stride()[:3]))


def _prep(x):
    if not _aligned(x):
        x = x.contiguous()
        if not _aligned(x):
            raise ValueError("flash_attention: a tensor's rows are not "
                             "16-byte aligned")
    return x


def _strides(x):
    return list(x.stride()[:3])


def _count(kind):
    with _count_lock:
        flash_attention.launches[kind] += 1


def _check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _validate(q, k, v, *rest):
    """Raise on a CUDA call the kernels do not take."""
    reason = _shape_reason(q, k, v)
    if reason is not None:
        raise ValueError(
            f"flash_attention: the CUDA kernels do not take this call "
            f"({reason}): q {q.dtype} {tuple(q.shape)}, k {k.dtype} "
            f"{tuple(k.shape)}, v {v.dtype} {tuple(v.shape)}; head_dim "
            f"must be in {SUPPORTED_HEAD_DIMS}, dtype float32 or bfloat16")
    for t in (k, v, *rest):
        if t.device != q.device:
            raise ValueError("flash_attention: all tensors must be on one "
                             f"device, got {q.device} and {t.device}")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Forward kernel: -> (o, lse float32 [b, h, sq]); one launch.  CPU
    tensors run `flash_attention_fwd_reference`."""
    if q.device.type != "cuda":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    _validate(q, k, v)
    q, k, v = _prep(q), _prep(k), _prep(v)
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, sq, k.shape[1], d,
            *_strides(q), *_strides(k), *_strides(v), _scale(q, scale),
            int(causal), _DTYPE_CODES[q.dtype], _stream(q))
    _check(rc, "flash_attention_fwd")
    _count("fwd")
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta):
    _validate(q, k, v, do, lse, delta)
    b, sq, h, _ = q.shape
    if do.shape != q.shape or lse.shape != (b, h, sq) \
            or delta.shape != (b, h, sq):
        raise ValueError(
            f"flash_attention backward: do {tuple(do.shape)}, lse "
            f"{tuple(lse.shape)}, delta {tuple(delta.shape)} for q "
            f"{tuple(q.shape)} (want do like q, lse and delta [b, h, sq])")
    q, k, v = _prep(q), _prep(k), _prep(v)
    do = do.to(q.dtype).contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    return q, k, v, do, lse, delta


def flash_attention_dq(q, k, v, do, lse, delta, causal=False, scale=None):
    """dQ kernel: -> dq; one launch.  CPU tensors run
    `flash_attention_dq_reference`."""
    if q.device.type != "cuda":
        return flash_attention_dq_reference(q, k, v, do, lse, delta,
                                            causal, scale)
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq,
            k.shape[1], d, *_strides(q), *_strides(k), *_strides(v),
            _scale(q, scale), int(causal), _DTYPE_CODES[q.dtype],
            _stream(q))
    _check(rc, "flash_attention_bwd_dq")
    _count("dq")
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal=False, scale=None):
    """dK/dV kernel: -> (dk, dv); one launch.  CPU tensors run
    `flash_attention_dkv_reference`."""
    if q.device.type != "cuda":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                             causal, scale)
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, sk, d, *_strides(q), *_strides(k), *_strides(v),
            _scale(q, scale), int(causal), _DTYPE_CODES[q.dtype],
            _stream(q))
    _check(rc, "flash_attention_bwd_dkv")
    _count("dkv")
    return dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, causal=False, scale=None):
    """The backward from the forward's output `o` and its `lse`: delta =
    rowsum(dO * O), then the dQ and dK/dV kernels -> (dq, dk, dv); two
    launches.  CPU tensors run the plain versions."""
    delta = attention_delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


_LSE_ATTR = "flash_attention_lse"


def saved_lse(o):
    """The logsumexp the forward kernel wrote beside `o` (a tensor
    `flash_attention` returned on a card), or None."""
    return getattr(o, _LSE_ATTR, None)


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd, in the setup_context form (so
    torch.func transforms accept it too)."""

    @staticmethod
    def forward(q, k, v, causal, scale):
        return flash_attention_fwd(q, k, v, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, do, lse, ctx.causal,
                                     ctx.scale), None, None)


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cuda")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool, scale: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel as the PyTorch op
    `paddle_tpu_torch::flash_attention_fwd` -> (o, lse): what a traced
    program (torch.export, io.export_aot_model) records in place of the
    ctypes launch, which a fake tensor cannot make.  On CUDA tensors it
    is `flash_attention_fwd` (one launch, counted); on CPU tensors
    `flash_attention_fwd_reference`; fake and meta tensors get shapes
    and dtypes only.  `scale` is explicit (no None)."""
    return flash_attention_fwd(q, k, v, causal, scale)


@flash_attention_fwd_op.register_kernel("cpu")
def _flash_attention_fwd_cpu(q, k, v, causal, scale):
    o, lse = flash_attention_fwd_reference(q, k, v, causal, scale)
    return o.contiguous(), lse.contiguous()


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, scale):
    b, sq, h, _ = q.shape
    return (q.new_empty((b, sq, h, v.shape[3])),
            q.new_empty((b, h, sq), dtype=torch.float32))


def flash_attention(q, k, v, causal=False, scale=None):
    """Attention over [batch, seq, heads, head_dim] tensors (K/V may have
    another seq length).  `scale` None means 1/sqrt(head_dim).  CPU and
    meta tensors run the plain version; CUDA tensors launch the kernels
    (forward now, dQ and dK/dV when autograd asks for gradients) or
    raise when the kernels cannot take them.  On a card the result
    carries the forward's logsumexp (`saved_lse`).  While torch.export
    traces, on any device, the forward is the op
    `paddle_tpu_torch::flash_attention_fwd` (`flash_attention_fwd_op`)
    and the result carries no logsumexp: an exported program is an
    inference program.  Eager calls keep the direct launch, whose host
    cost is lower than the op's dispatch (PERF.md)."""
    if torch.compiler.is_exporting():
        return flash_attention_fwd_op(q, k, v, bool(causal),
                                      _scale(q, scale))[0]
    if q.device.type != "cuda":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    _validate(q, k, v)
    o, lse = _FlashAttention.apply(q, k, v, bool(causal), _scale(q, scale))
    setattr(o, _LSE_ATTR, lse)
    return o


flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
