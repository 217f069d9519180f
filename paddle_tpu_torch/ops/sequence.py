"""Sequence (LoD) ops (counterpart of paddle_tpu/ops/sequence.py).

Reference: PaddlePaddle's operators/sequence_*.cc, lod_reset_op.cc,
im2sequence_op.cc and the math/ sequence kernels.

The LoD is host metadata, so every index a lowering needs (the padded
[B, T] gather of a recurrence, the rows a pooling or an expansion reads,
the segment lengths) is a table built on the host from the LoD and kept
in the run's `ctx.tables` (`_table`).  The Executor gives every cache
entry (one per LoD) a dict of its own: the entry's eager first run
builds its tables, a replay does not rebuild them in Python, and the
capture at the entry's first hit reads the same tensors, so a CUDA
graph captures no host-to-device copy and its tables go with it.

Deterministic gradients: every row gather here is a `_Rows` plan whose
backward is fixed on the host as well — a gather back when each source
row is read at most once (padding, repacking, a slice, a permutation),
else a sorted segment sum of the cotangent rows (`segment_reduce`, one
sequential sum per output element, in increasing position), never
`index_add_`'s atomics.  So the gradients of sequence_expand, of the
SUM/AVERAGE/SQRT pools and of every gather with repeated rows give the
same bits on every call on a card.  Positions that read padding
(`valid` false) read row 0, as the JAX package's, and take no gradient:
every lowering masks them, so their cotangent is zero there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.execution import data_of, many, one
from ..core.lod import LoDTensor, lod_from_seq_lens
from ..core.registry import register_infer_shape, register_op
from ..core.shape_inference import input_var, set_output_shape
from ..core.types import torch_dtype


def _seq_lens(lod_level):
    return [lod_level[i + 1] - lod_level[i] for i in range(len(lod_level) - 1)]


def _segment_ids(lod_level) -> np.ndarray:
    return np.repeat(np.arange(len(lod_level) - 1, dtype=np.int64),
                     np.diff(np.asarray(lod_level, np.int64)))


def lod_to_padded_index(lod_level):
    """Static (rows -> padded) gather indices: (index [B, T] into the
    packed row axis, 0 past each sequence's length; mask [B, T] float32)."""
    lens = _seq_lens(lod_level)
    bsz = len(lens)
    tmax = max(lens) if lens else 0
    idx = np.zeros((bsz, tmax), dtype=np.int64)
    mask = np.zeros((bsz, tmax), dtype=np.float32)
    for i, ln in enumerate(lens):
        idx[i, :ln] = np.arange(lod_level[i], lod_level[i] + ln)
        mask[i, :ln] = 1.0
    return idx, mask


def padded_to_lod_index(lod_level):
    """Static flat gather indices mapping padded [B, T] back to packed
    rows."""
    lens = _seq_lens(lod_level)
    tmax = max(lens) if lens else 0
    out = []
    for i, ln in enumerate(lens):
        out.extend(i * tmax + t for t in range(ln))
    return np.asarray(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# host-built tables and deterministic row gathers
# ---------------------------------------------------------------------------


def _table(ctx, key, device, build):
    """`build()` (numpy arrays, ints or _Rows specs, in a tuple) moved to
    `device`, built at the first use of (key, device) in `ctx.tables`
    and reused after."""
    device = torch.device(device)
    k = ("sequence", key, device)
    hit = ctx.tables.get(k)
    if hit is None:
        hit = ctx.tables[k] = tuple(_on(v, device) for v in build())
    return hit


def _on(v, device):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v).to(device)
    if isinstance(v, _RowSpec):
        return _Rows(v, device)
    return v


class _RowSpec:
    """A row gather out[k] = x[idx[k]] on the host: `idx` [M] into `n`
    source rows, `valid` [M] the positions whose gradient flows."""

    def __init__(self, idx, n, valid=None):
        self.idx = np.asarray(idx, np.int64).reshape(-1)
        self.n = int(n)
        self.valid = (np.ones(self.idx.shape, bool) if valid is None
                      else np.asarray(valid, bool).reshape(-1))


class _Rows:
    """A `_RowSpec` on a device, with its backward: when no source row
    is read twice, the source rows' positions (`src`, `pos`: the
    cotangent rows copied back, every other row zero); else the valid
    positions in source-row order (a stable sort) and each source row's
    count, for a segment sum."""

    def __init__(self, spec: _RowSpec, device):
        self.n = spec.n
        self.idx = torch.from_numpy(spec.idx).to(device)
        pos = np.nonzero(spec.valid)[0]
        src = spec.idx[pos]
        counts = np.bincount(src, minlength=spec.n) if src.size else \
            np.zeros(spec.n, np.int64)
        self.unique = bool(counts.max(initial=0) <= 1)
        if self.unique:
            self.src = torch.from_numpy(src).to(device)
            self.pos = torch.from_numpy(pos).to(device)
        else:
            order = pos[np.argsort(src, kind="stable")]
            self.order = torch.from_numpy(order).to(device)
            self.counts = torch.from_numpy(counts.astype(np.int64)).to(device)

    def backward(self, g):
        """d(source) from d(out): each source row the sum of the
        cotangent rows that read it, in increasing position."""
        shape = (self.n,) + tuple(g.shape[1:])
        if self.unique:
            out = g.new_zeros(shape)
            return out.index_copy_(0, self.src, g.index_select(0, self.pos))
        if g.shape[0] == 0 or self.n == 0:
            return g.new_zeros(shape)
        return torch.segment_reduce(g.index_select(0, self.order), "sum",
                                    lengths=self.counts, axis=0, unsafe=True)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return x.index_select(0, rows.idx)

    @staticmethod
    def backward(ctx, g):
        return ctx.rows.backward(g.contiguous()), None


def gather_rows(x, rows: _Rows):
    """x[rows.idx] along dim 0, with the plan's deterministic backward."""
    if x.device.type == "meta":
        return x.index_select(0, rows.idx)
    return _Gather.apply(x, rows)


class _SegmentSum(torch.autograd.Function):
    """Contiguous segments summed (`lengths` [S]); the backward repeats
    each segment's cotangent over its rows (`seg` [N], a gather)."""

    @staticmethod
    def forward(ctx, x, lengths, seg):
        ctx.seg = seg
        if x.shape[0] == 0:
            return x.new_zeros((lengths.shape[0],) + tuple(x.shape[1:]))
        return torch.segment_reduce(x, "sum", lengths=lengths, axis=0,
                                    unsafe=True)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.seg), None, None


def segment_sum(x, lengths, seg):
    return _SegmentSum.apply(x, lengths, seg)


def _lod_key(lod):
    return tuple(int(v) for v in lod)


def padded_rows(ctx, lod, device, reverse=False):
    """(_Rows packed -> padded [B*T], the mask [B, T] as float32, T):
    pads read row 0 and take no gradient; with `reverse` each sequence's
    rows run backwards within its valid region (padding stays at the
    tail)."""
    def build():
        idx, mask = lod_to_padded_index(lod)
        if reverse:
            for i in range(idx.shape[0]):
                ln = int(mask[i].sum())
                idx[i, :ln] = idx[i, :ln][::-1]
        return (_RowSpec(idx, lod[-1] if lod else 0, mask > 0), mask,
                idx.shape[1])

    return _table(ctx, ("padded", _lod_key(lod), reverse), device, build)


def repack_rows(ctx, lod, t, device, reverse=False):
    """_Rows padded [B*T] -> packed rows (each valid position once)."""
    def build():
        lens = _seq_lens(lod)
        if reverse:
            flat = [i * t + (ln - 1 - k) for i, ln in enumerate(lens)
                    for k in range(ln)]
        else:
            flat = padded_to_lod_index(lod)
        return (_RowSpec(flat, len(lens) * t),)

    return _table(ctx, ("repack", _lod_key(lod), t, reverse), device,
                  build)[0]


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _lod_input(xv, op):
    if not (isinstance(xv, LoDTensor) and xv.lod):
        raise TypeError(f"{op} requires a LoDTensor input")
    return xv


# ---------------------------------------------------------------------------
# pooling / softmax
# ---------------------------------------------------------------------------


@register_op("sequence_pool", inputs=("X",), outputs=("Out", "MaxIndex"),
             attrs={"pooltype": "AVERAGE"}, diff_outputs=("Out",), lod=True)
def sequence_pool(ctx, ins, attrs):
    """One row per sequence of the last LoD level.  MAX routes each
    element's gradient to one row, the first of its maxima (an argmax
    over the padded sequence, then a gather), and gives an empty
    sequence the dtype's minimum and a zero gradient."""
    xv = _lod_input(one(ins, "X"), "sequence_pool")
    lod = xv.lod[-1]
    x = xv.data
    dev = x.device
    pt = attrs["pooltype"].upper()
    if pt in ("SUM", "AVERAGE", "SQRT"):
        lengths, seg, lens = _table(
            ctx, ("segments", _lod_key(lod)), dev,
            lambda: (np.asarray(_seq_lens(lod), np.int64),
                     _segment_ids(lod),
                     np.maximum(np.asarray(_seq_lens(lod), np.float64), 1)
                     .reshape(-1, 1)))
        out = segment_sum(x, lengths, seg)
        if pt == "AVERAGE":
            out = out / lens.to(x.dtype)
        elif pt == "SQRT":
            out = out / torch.sqrt(lens.to(x.dtype))
    elif pt == "MAX":
        rows, mask, t = padded_rows(ctx, lod, dev)
        nseq = len(lod) - 1
        feat = x.dim() - 1
        neg = (torch.finfo(x.dtype).min if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        if t == 0:   # every sequence empty
            out = torch.full((nseq,) + tuple(x.shape[1:]), neg,
                             dtype=x.dtype, device=dev)
        else:
            xp = gather_rows(x, rows).reshape((nseq, t) + tuple(x.shape[1:]))
            m = mask.reshape(tuple(mask.shape) + (1,) * feat) > 0
            negt = torch.full((), neg, dtype=x.dtype, device=dev)
            am = torch.argmax(torch.where(m, xp, negt).detach(), dim=1)
            out = torch.take_along_dim(xp, am[:, None], dim=1)[:, 0]
            lens = _seq_lens(lod)
            if 0 in lens:
                # the pad gather read row 0 for an empty sequence: the
                # max's identity instead, with a zero gradient
                empty, = _table(ctx, ("empty", _lod_key(lod)), dev,
                                lambda: (np.asarray(lens) == 0,))
                out = torch.where(empty.reshape((-1,) + (1,) * feat),
                                  negt, out)
    elif pt in ("LAST", "FIRST"):
        rows, = _table(ctx, ("ends", _lod_key(lod), pt), dev, lambda: (
            _RowSpec([o - 1 for o in lod[1:]] if pt == "LAST"
                     else lod[:-1], x.shape[0]),))
        out = gather_rows(x, rows)
    else:
        raise ValueError(f"unknown pooltype {pt}")
    new_lod = xv.lod[:-1]
    return {"Out": LoDTensor(out, new_lod) if new_lod else out,
            "MaxIndex": None}


@register_op("sequence_softmax", inputs=("X",), outputs=("Out",), lod=True)
def sequence_softmax(ctx, ins, attrs):
    """Softmax within each sequence; its maximum is a constant (softmax
    is shift-invariant, so its gradient cancels exactly)."""
    xv = one(ins, "X")
    lod = xv.lod[-1]
    x = xv.data.reshape(-1)
    lengths, seg, rows = _table(
        ctx, ("softmax", _lod_key(lod)), x.device,
        lambda: (np.asarray(_seq_lens(lod), np.int64), _segment_ids(lod),
                 _RowSpec(_segment_ids(lod), len(lod) - 1)))
    if x.shape[0]:
        smax = torch.segment_reduce(x.detach(), "max", lengths=lengths,
                                    unsafe=True)
    else:
        smax = x.new_zeros(lengths.shape)
    e = torch.exp(x - smax.index_select(0, seg))
    ssum = segment_sum(e, lengths, seg)
    out = e / gather_rows(ssum, rows)
    return {"Out": LoDTensor(out.reshape(xv.data.shape), xv.lod)}


# ---------------------------------------------------------------------------
# expand / concat / reshape / erase / slice / lod_reset
# ---------------------------------------------------------------------------


@register_op("sequence_expand", inputs=("X", "Y"), outputs=("Out",),
             diff_inputs=("X",), lod=True)
def sequence_expand(ctx, ins, attrs):
    """X row i repeated as often as sequence i of Y's last LoD level is
    long (the reference sequence_expand_op.h kernel); Out.lod = Y.lod.
    X's own LoD does not take part (the beam-search decode idiom)."""
    x = data_of(one(ins, "X"))
    yv = one(ins, "Y")
    y_lens = _seq_lens(yv.lod[-1])
    if len(y_lens) != x.shape[0]:
        raise ValueError(
            f"sequence_expand: X has {x.shape[0]} rows but Y's last LoD "
            f"level has {len(y_lens)} sequences")
    rows, = _table(ctx, ("expand", _lod_key(yv.lod[-1])), x.device,
                   lambda: (_RowSpec(np.repeat(np.arange(len(y_lens)),
                                               y_lens), x.shape[0]),))
    return {"Out": LoDTensor(gather_rows(x, rows), yv.lod)}


@register_op("sequence_concat", inputs=("X",), outputs=("Out",),
             dup_inputs=("X",), attrs={"axis": 0, "level": 0}, lod=True)
def sequence_concat(ctx, ins, attrs):
    """Corresponding sequences of each input joined (the reference
    sequence_concat_op.cc, axis 0)."""
    xs = many(ins, "X")
    lods = tuple(_lod_key(x.lod[-1]) for x in xs)
    heights = tuple(int(x.data.shape[0]) for x in xs)

    def build():
        order, out_lens, offset = [], [], np.cumsum((0,) + heights)
        for i in range(len(lods[0]) - 1):
            total = 0
            for k, lod in enumerate(lods):
                order.extend(range(offset[k] + lod[i], offset[k] + lod[i + 1]))
                total += lod[i + 1] - lod[i]
            out_lens.append(total)
        return _RowSpec(order, offset[-1]), lod_from_seq_lens(out_lens)

    rows, out_lod = _table(ctx, ("concat", lods, heights),
                           xs[0].data.device, build)
    data = torch.cat([x.data for x in xs], dim=0)
    return {"Out": LoDTensor(gather_rows(data, rows), [out_lod])}


@register_op("sequence_reshape", inputs=("X",), outputs=("Out",),
             attrs={"new_dim": 1}, lod=True)
def sequence_reshape(ctx, ins, attrs):
    xv = one(ins, "X")
    x = xv.data
    new_dim = attrs["new_dim"]
    old_dim = x.shape[-1]
    out_lens = [ln * old_dim // new_dim for ln in _seq_lens(xv.lod[-1])]
    return {"Out": LoDTensor(x.reshape(-1, new_dim),
                             [lod_from_seq_lens(out_lens)])}


@register_op("sequence_erase", inputs=("X",), outputs=("Out",),
             attrs={"tokens": []}, not_differentiable=True, host=True,
             lod=True)
def sequence_erase(ctx, ins, attrs):
    """The rows whose token is in `tokens` removed (an output size the
    data decides: a host op, as the reference sequence_erase_op.cc)."""
    xv = one(ins, "X")
    x = xv.data.cpu().numpy()
    tokens = set(attrs["tokens"])
    lod = xv.lod[-1]
    keep, out_lens = [], []
    for i in range(len(lod) - 1):
        rows = [r for r in range(lod[i], lod[i + 1])
                if int(x[r].reshape(-1)[0]) not in tokens]
        keep.extend(rows)
        out_lens.append(len(rows))
    out = xv.data[torch.as_tensor(keep, dtype=torch.long,
                                  device=xv.data.device)]
    return {"Out": LoDTensor(out, [lod_from_seq_lens(out_lens)])}


@register_op("sequence_slice", inputs=("X", "Offset", "Length"),
             outputs=("Out",), diff_inputs=("X",), host=True, lod=True)
def sequence_slice(ctx, ins, attrs):
    """Sequence i's rows [Offset[i], Offset[i] + Length[i]); the offsets
    and lengths are read on the host (a host op)."""
    xv = one(ins, "X")
    off = data_of(one(ins, "Offset")).reshape(-1).tolist()
    length = data_of(one(ins, "Length")).reshape(-1).tolist()
    lod = xv.lod[-1]
    rows = []
    for i in range(len(lod) - 1):
        start = lod[i] + int(off[i])
        rows.extend(range(start, start + int(length[i])))
    plan = _Rows(_RowSpec(rows, xv.data.shape[0]), xv.data.device)
    return {"Out": LoDTensor(gather_rows(xv.data, plan),
                             [lod_from_seq_lens(int(n) for n in length)])}


@register_op("lod_reset", inputs=("X", "Y"), outputs=("Out",),
             attrs={"target_lod": []}, lod=True)
def lod_reset(ctx, ins, attrs):
    """X's data with a new one-level LoD: Y's last level, Y's values
    (read on the host), or `target_lod`."""
    x = data_of(one(ins, "X"))
    y = one(ins, "Y")
    if isinstance(y, LoDTensor) and y.lod:
        lod = y.lod[-1]
    elif y is not None:
        lod = tuple(int(v) for v in data_of(y).reshape(-1).tolist())
    else:
        lod = tuple(int(v) for v in attrs["target_lod"])
    return {"Out": LoDTensor(x, [lod])}


@register_op("im2sequence", inputs=("X",), outputs=("Out",),
             attrs={"kernels": [1, 1], "strides": [1, 1],
                    "paddings": [0, 0, 0, 0]}, lod=True)
def im2sequence(ctx, ins, attrs):
    """Image -> one sequence per image of its flattened sliding windows
    (the reference im2sequence_op.cc), each row ordered (C, kh, kw)."""
    x = data_of(one(ins, "X"))  # [N, C, H, W]
    kh, kw = attrs["kernels"]
    sh, sw = attrs["strides"]
    pu, pl, pd, pr = (list(attrs["paddings"]) + [0, 0, 0, 0])[:4]
    x = F.pad(x, (pl, pr, pu, pd))
    n, c, h, w = x.shape
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    patches = F.unfold(x, (kh, kw), stride=(sh, sw))   # [N, C*kh*kw, L]
    out = patches.transpose(1, 2).reshape(n * oh * ow, c * kh * kw)
    return {"Out": LoDTensor(out, [lod_from_seq_lens([oh * ow] * n)])}


# ---------------------------------------------------------------------------
# sequence_conv (context projection)
# ---------------------------------------------------------------------------


@register_op("sequence_conv", inputs=("X", "Filter", "PaddingData"),
             outputs=("Out",),
             attrs={"contextLength": 3, "contextStart": -1,
                    "contextStride": 1},
             diff_inputs=("X", "Filter"), lod=True)
def sequence_conv(ctx, ins, attrs):
    """Context-window projection per sequence (the reference
    sequence_conv_op.cc, math/context_project.h): each row gathers its
    `contextLength` neighbours (zero outside its sequence), flattened,
    times Filter [contextLength * D, M]."""
    xv = one(ins, "X")
    w = data_of(one(ins, "Filter"))
    lod = xv.lod[-1]
    x = xv.data
    n, d = x.shape
    ctx_len = attrs["contextLength"]
    ctx_start = attrs["contextStart"]

    def build():
        idx = np.zeros((n, ctx_len), np.int64)
        mask = np.zeros((n, ctx_len), np.float32)
        for i in range(len(lod) - 1):
            lo, hi = lod[i], lod[i + 1]
            for r in range(lo, hi):
                for j in range(ctx_len):
                    src = r + ctx_start + j
                    if lo <= src < hi:
                        idx[r, j] = src
                        mask[r, j] = 1.0
        return _RowSpec(idx, n, mask > 0), mask[:, :, None]

    rows, mask = _table(ctx, ("context", _lod_key(lod), ctx_len,
                              ctx_start), x.device, build)
    gathered = gather_rows(x, rows).reshape(n, ctx_len, d)
    gathered = gathered * mask.to(x.dtype)
    out = torch.matmul(*_promoted(gathered.reshape(n, ctx_len * d), w))
    return {"Out": LoDTensor(out, xv.lod)}


# ---------------------------------------------------------------------------
# padding (the reference's math/sequence_padding)
# ---------------------------------------------------------------------------


@register_op("sequence_pad", inputs=("X",), outputs=("Out", "Length"),
             attrs={"pad_value": 0.0, "padded_length": -1},
             diff_outputs=("Out",), lod=True)
def sequence_pad(ctx, ins, attrs):
    """[B, T, ...] padded with `pad_value`; T the longest sequence, or
    `padded_length` when positive (a fixed time axis)."""
    xv = one(ins, "X")
    lod = xv.lod[-1]
    x = xv.data
    want = int(attrs.get("padded_length", -1))

    def build():
        idx, mask = lod_to_padded_index(lod)
        t = idx.shape[1]
        if want > 0:
            if want < t:
                raise ValueError(f"sequence_pad: padded_length {want} < "
                                 f"longest sequence {t}")
            idx = np.pad(idx, ((0, 0), (0, want - t)))
            mask = np.pad(mask, ((0, 0), (0, want - t)))
        return (_RowSpec(idx, x.shape[0], mask > 0), mask,
                np.asarray(_seq_lens(lod), np.int64))

    rows, mask, lengths = _table(ctx, ("pad", _lod_key(lod), want),
                                 x.device, build)
    out = gather_rows(x, rows).reshape(tuple(mask.shape)
                                       + tuple(x.shape[1:]))
    m = mask.reshape(tuple(mask.shape) + (1,) * (out.dim() - 2)).to(x.dtype)
    pad = torch.full((), attrs["pad_value"], dtype=x.dtype, device=x.device)
    return {"Out": out * m + pad * (1 - m), "Length": lengths.clone()}


@register_op("sequence_unpad", inputs=("X", "Length"), outputs=("Out",),
             diff_inputs=("X",), host=True, lod=True)
def sequence_unpad(ctx, ins, attrs):
    """[B, T, ...] -> the packed rows of the given lengths (read on the
    host: a host op)."""
    x = data_of(one(ins, "X"))
    lens = [int(v) for v in data_of(one(ins, "Length")).reshape(-1).tolist()]
    lod = lod_from_seq_lens(lens)
    plan = _Rows(_RowSpec(padded_to_lod_index(lod), x.shape[0] * x.shape[1]),
                 x.device)
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    return {"Out": LoDTensor(gather_rows(flat, plan), [lod])}


@register_op("sequence_mask", inputs=("X",), outputs=("Y",),
             attrs={"maxlen": -1, "out_dtype": "float32"},
             not_differentiable=True, lod=True)
def sequence_mask(ctx, ins, attrs):
    """[N] lengths -> [N, maxlen] 0/1 mask; maxlen <= 0 reads the longest
    length on the host (the interpreter's case, as in the JAX package)."""
    lens = data_of(one(ins, "X")).reshape(-1)
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen <= 0:
        maxlen = int(lens.max())
    j = torch.arange(maxlen, device=lens.device)
    return {"Y": (j[None, :] < lens[:, None]).to(
        torch_dtype(attrs.get("out_dtype", "float32")))}


# ---------------------------------------------------------------------------
# explicit build-time shape inference (LoD-dependent ops)
# ---------------------------------------------------------------------------
# Meta tensors carry no LoD, so these lowerings cannot run at build time;
# row counts that depend on the LoD are -1, as in the JAX package.


@register_infer_shape("sequence_pool")
def _infer_sequence_pool(op, block):
    x = input_var(op, block, "X")
    if x is None or x.shape is None:
        return
    # one pooled row per sequence; the sequence count lives in the LoD
    set_output_shape(op, block, "Out", (-1,) + tuple(x.shape[1:]), x.dtype)


@register_infer_shape("sequence_softmax")
def _infer_sequence_softmax(op, block):
    x = input_var(op, block, "X")
    if x is None or x.shape is None:
        return
    set_output_shape(op, block, "Out", x.shape, x.dtype)


@register_infer_shape("sequence_expand")
def _infer_sequence_expand(op, block):
    x = input_var(op, block, "X")
    if x is None or x.shape is None:
        return
    set_output_shape(op, block, "Out", (-1,) + tuple(x.shape[1:]), x.dtype)


@register_infer_shape("sequence_conv")
def _infer_sequence_conv(op, block):
    x = input_var(op, block, "X")
    f = input_var(op, block, "Filter")
    if x is None or x.shape is None or f is None or f.shape is None:
        return
    set_output_shape(op, block, "Out", (x.shape[0], f.shape[1]), x.dtype)


@register_infer_shape("sequence_reshape")
def _infer_sequence_reshape(op, block):
    x = input_var(op, block, "X")
    if x is None or x.shape is None:
        return
    new_dim = int(op.attrs.get("new_dim", 1))
    set_output_shape(op, block, "Out", (-1, new_dim), x.dtype)
